"""The port's workflow (DAG) path against the JAX package.

Tolerance 0 throughout.  The DAG generators, ``upward_ranks`` and the
registry are bit-equal; ``dep_state``, ``is_terminal`` and
``init_state(parents=)`` equal on random status and parent tables; the
port's ``run_sweep(parents=)`` is bitwise the JAX one (Pallas off and
on, interpret mode) for all ten policies on ``tests/test_workflows.py``'s
instances, the failure + DVFS scenario, the cascade case and an empty
parent table; the port's ``simulate_ref(parents=)`` equals the JAX
oracle.  On the four instances where the JAX engine and its oracle
disagree (ROADMAP.md, queue C) the port's engine equals the JAX engine
and the port's oracle the JAX oracle.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_workflows import make_dag_instance

from repro.core import engine as E
from repro.core import ref_engine as R
from repro.core import schedulers as P
from repro.core import state as JS
from repro.core import workload as JW
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import ref_engine as TR
from repro_torch.core import state as TS
from repro_torch.core import workload as TW
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
FIELDS = (("tasks", "status"), ("tasks", "machine"), ("tasks", "seq"),
          ("tasks", "t_start"), ("tasks", "t_end"),
          ("machines", "busy_until"), ("machines", "active_time"),
          ("machines", "energy"), (None, "n_events"), (None, "time"),
          (None, "n_live"), (None, "n_batch"), (None, "deps_left"),
          (None, "n_preempts"))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _port_workflow(wf) -> TW.Workflow:
    wl = wf.workload
    return TW.Workflow(TW.Workload(wl.arrival, wl.type_id, wl.deadline),
                       wf.parents)


# ---------------------------------------------------------------------------
# generators, ranks, registry
# ---------------------------------------------------------------------------
GENERATORS = {
    "chain": lambda m, s: m.chain_workflow(23, 3, slack=3.0, seed=s),
    "fork_join": lambda m, s: m.fork_join_workflow(
        5, 3, 2, mean_eet=np.array([1.5, 0.25], np.float32),
        slack_jitter=0.4, seed=s),
    "map_reduce": lambda m, s: m.map_reduce_workflow(
        9, 3, 4, t0=2.5, slack_jitter=0.2, seed=s),
    "layered": lambda m, s: m.layered_workflow(
        40, 3, n_layers=5, max_parents=4,
        mean_eet=np.array([1.0, 2.5, 0.5], np.float32), slack_jitter=0.3,
        seed=s),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bit_equal(name):
    for seed in (0, 7, 8205):
        a, b = GENERATORS[name](JW, seed), GENERATORS[name](TW, seed)
        _same(a.parents, b.parents, f"{name} parents")
        for col in ("arrival", "type_id", "deadline"):
            _same(getattr(a.workload, col), getattr(b.workload, col),
                  f"{name} {col}")
        assert a.n_edges == b.n_edges
        me = np.array([1.0, 3.0, 0.5, 2.0], np.float32)[:max(
            b.workload.type_id) + 1]
        _same(a.ranks(me), b.ranks(me), f"{name} ranks")
        _same(a.ranks(), b.ranks(), f"{name} unit ranks")


def test_registry_bit_equal():
    assert list(TW.WORKFLOW_GENERATORS) == list(JW.WORKFLOW_GENERATORS)
    me = np.array([1.0, 2.5, 0.5], np.float32)
    for name in TW.WORKFLOW_GENERATORS:
        for n in (1, 2, 17, 64):
            a = JW.WORKFLOW_GENERATORS[name](n, 3, me, 5)
            b = TW.WORKFLOW_GENERATORS[name](n, 3, me, 5)
            _same(a.parents, b.parents, f"{name} n={n}")
            _same(a.workload.deadline, b.workload.deadline, name)
    assert TW.resolve_shapes(["layered", "chain"]) == ("layered", "chain")
    with pytest.raises(ValueError, match="unknown workflow generators"):
        TW.resolve_shapes(["spiral"])


def test_register_workflow_generator(monkeypatch):
    """A registered shape is a valid ``WorkloadAxis(shapes=...)`` value
    and drives ``normalize``; duplicates raise.  The port's registry is
    restored afterwards; the JAX registry is never touched."""
    reg = dict(TW.WORKFLOW_GENERATORS)
    monkeypatch.setattr(TW, "WORKFLOW_GENERATORS", reg)
    monkeypatch.setattr(TX, "WORKFLOW_GENERATORS", reg)
    jax_names = list(JW.WORKFLOW_GENERATORS)

    def diamond(n, ntt, me, seed):
        return TW.fork_join_workflow(max(n - 2, 1) // 2, 2, ntt,
                                     mean_eet=me, seed=seed)

    TW.register_workflow_generator("diamond", diamond)
    with pytest.raises(ValueError, match="already registered"):
        TW.register_workflow_generator("diamond", diamond)
    with pytest.raises(ValueError, match="already registered"):
        TW.register_workflow_generator("chain", diamond)
    spec = TX.ExperimentSpec(4, TX.FleetAxis(3),
                             TX.WorkloadAxis(12, shapes=("diamond",)),
                             policy=TX.PolicyAxis(("mct", "heft")))
    reps = TX.normalize(spec, device="cpu")
    want = JW.fork_join_workflow(5, 2, 4, seed=0)
    _same(want.parents, reps.parents[0].numpy(), "registered shape")
    assert list(JW.WORKFLOW_GENERATORS) == jax_names


def test_upward_ranks_bit_equal():
    rng = np.random.default_rng(3)
    for n, k in ((1, 1), (9, 2), (60, 5)):
        parents = np.full((n, k), -1, np.int32)
        for i in range(1, n):
            ps = rng.choice(i, size=min(i, rng.integers(0, k + 1)),
                            replace=False)
            parents[i, :len(ps)] = np.sort(ps)
        w = rng.uniform(0.1, 5.0, n)
        _same(JW.upward_ranks(parents, w), TW.upward_ranks(parents, w),
              f"n={n}")
    np.testing.assert_array_equal(
        TW.upward_ranks(np.array([[-1], [0], [1]]), [1.0, 2.0, 3.0]),
        [6.0, 5.0, 3.0])


def test_workflow_validation():
    wl = TW.Workload(np.zeros(3, np.float32), np.zeros(3, np.int32),
                     np.full(3, 10.0, np.float32))
    with pytest.raises(ValueError, match="topological"):
        TW.Workflow(wl, np.array([[1], [-1], [-1]], np.int32))
    with pytest.raises(ValueError, match="n_tasks"):
        TW.Workflow(wl, np.full((2, 1), -1, np.int32))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dep_state_matches_jax(seed):
    rng = np.random.default_rng(seed)
    r, n, k = 6, 40, 4
    status = rng.integers(0, TS.NUM_STATUSES, (r, n)).astype(np.int32)
    parents = rng.integers(-1, n, (r, n, k)).astype(np.int32)
    parents[:, :3] = -1
    left_j, failed_j = jax.vmap(JS.dep_state)(jnp.asarray(status),
                                              jnp.asarray(parents))
    st, pt = torch.as_tensor(status), torch.as_tensor(parents)
    for index in (None, TS.dep_index(pt)):
        left, failed = TS.dep_state(st, pt, index)
        _same(left_j, left.numpy(), "left")
        _same(failed_j, failed.numpy(), "failed")
    _same(JS.is_terminal(jnp.asarray(status)),
          TS.is_terminal(st).numpy(), "is_terminal")
    assert failed.any() and (left == 0).any() and (left > 0).any()


def test_init_state_parents_matches_jax():
    eet, power, wf, mtype = make_dag_instance(4)
    tt = wf.workload.to_task_table()
    js = JS.init_state(tt, jnp.asarray(mtype, jnp.int32), None,
                       jnp.asarray(wf.parents))
    reps = interop.replicas_from_numpy(
        jax.tree.map(lambda x: x[None], tt), mtype[None],
        E.make_tables(eet, power, wf.n_tasks), np.zeros(1, np.int32),
        parents=wf.parents[None], device="cpu")
    ts = TS.init_state(reps.tasks, reps.mtype, None, reps.parents)
    _same(js.deps_left, ts.deps_left[0].numpy(), "deps_left")
    assert TS.init_state(reps.tasks, reps.mtype).deps_left is None


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _batch(instances):
    """One JAX replica batch: every policy on every (eet, power, wf,
    mtype, scenario) instance."""
    reps = []
    for eet, power, wf, mtype, scen in instances:
        tables = E.make_tables(eet, power, wf.n_tasks,
                               rank=wf.ranks(eet.eet.mean(1)))
        dyn = None if scen is None else scen.dynamics()
        for p in POLICIES:
            reps.append((wf.workload.to_task_table(),
                         jnp.asarray(mtype, jnp.int32), tables,
                         jnp.int32(P.POLICY_IDS[p]), dyn,
                         jnp.asarray(wf.parents)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *reps)


def _port_run(batch, params=TE.SimParams(), stats=None):
    tasks, mtype, tables, pids, dyn, parents = batch
    reps = interop.replicas_from_numpy(tasks, mtype, tables, pids, dyn,
                                       parents, device="cpu")
    return TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                        params, stats, reps.dynamics, reps.parents)


def _assert_bitwise(sj, st, what, rows=None):
    for group, name in FIELDS:
        a = np.asarray(getattr(sj if group is None else getattr(sj, group),
                               name))
        b = getattr(st if group is None else getattr(st, group),
                    name).numpy()
        if rows is not None:
            a, b = a[rows], b[rows]
        _same(a, b, f"{name} {what}")


def _cascade_instance():
    eet, power, _, _ = make_dag_instance(3)
    wf = JW.chain_workflow(6, 3, mean_eet=eet.eet.mean(1), slack=6.0)
    wl = wf.workload
    wl.deadline = wl.deadline.copy()
    wl.deadline[0] = 1e-4            # the head can never finish in time
    return eet, power, JW.Workflow(wl, wf.parents), np.array([0, 1]), None


@pytest.fixture(scope="module")
def instances():
    static = make_dag_instance(2) + (None,)
    eet, power, wf, mtype = make_dag_instance(3, slack=3.0)
    scen = JW.make_scenario(wf.workload, len(mtype), fail_rate=0.06,
                            mttr=3.0, spot=False, dvfs="powersave", seed=3)
    return {"static": static, "dynamic": (eet, power, wf, mtype, scen),
            "cascade": _cascade_instance()}


@pytest.fixture(scope="module")
def runs(instances):
    out = {}
    for name, inst in instances.items():
        batch = _batch([inst])
        jax_states = {pallas: E.run_sweep(*batch[:4], E.SimParams(
            pallas=pallas), batch[4], None, batch[5])
            for pallas in (False, True)}
        stats = TE.RunStats()
        out[name] = (jax_states, _port_run(batch, stats=stats), stats)
    return out


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("case", ["static", "dynamic", "cascade"])
def test_run_sweep_parents_bitwise_matches_jax(runs, case, pallas):
    jax_states, st, _ = runs[case]
    _assert_bitwise(jax_states[pallas], st, f"{case} pallas={pallas}")
    assert bool(TS.is_terminal(st.tasks.status).all())


def test_cascade_cancels_the_chain(runs):
    _, st, stats = runs["cascade"]
    for i, p in enumerate(POLICIES):
        status = st.tasks.status[i].numpy()
        assert status[0] in (TS.CANCELLED, TS.MISSED_QUEUE,
                             TS.MISSED_RUNNING), p
        np.testing.assert_array_equal(status[1:], TS.CANCELLED, err_msg=p)
        assert (st.tasks.t_start[i, 1:] < 0).all(), p
    # the head's cancel is a cascade of five levels in one event
    assert stats.release_trips > stats.events


def test_precedence_holds(runs, instances):
    for case in ("static", "dynamic"):
        _, st, _ = runs[case]
        parents = instances[case][2].parents
        for i, p in enumerate(POLICIES):
            status = st.tasks.status[i].numpy()
            t_start = st.tasks.t_start[i].numpy()
            t_end = st.tasks.t_end[i].numpy()
            for t in range(len(status)):
                ps = [int(q) for q in parents[t] if q >= 0]
                if t_start[t] >= 0:
                    assert all(status[q] == TS.COMPLETED
                               and t_start[t] >= t_end[q] for q in ps), \
                        (case, p, t)


def test_empty_parent_table_matches_independent():
    """A parent table without edges gives the independent-task run,
    bitwise, and the JAX engine's result on the same table."""
    eet, power, wf, mtype = make_dag_instance(5)
    empty = JW.Workflow(wf.workload, np.full_like(wf.parents, -1))
    batch = _batch([(eet, power, empty, mtype, None)])
    sj = E.run_sweep(*batch[:4], E.SimParams(), None, None, batch[5])
    st = _port_run(batch)
    _assert_bitwise(sj, st, "empty table")
    indep = _port_run(batch[:5] + (None,))
    for group, name in FIELDS:
        if name in ("deps_left", "n_events"):
            continue
        a = getattr(st if group is None else getattr(st, group), name)
        b = getattr(indep if group is None else getattr(indep, group), name)
        _same(a.numpy(), b.numpy(), f"{name} empty vs independent")
    assert int(st.deps_left.sum()) == 0


@pytest.mark.parametrize("policy", ["mct", "heft", "minmin"])
def test_simulate_workflow_matches_jax(policy):
    eet, power, wf, mtype = make_dag_instance(6, slack=2.5)
    sj = E.simulate(wf, eet, power, mtype, policy=policy)
    st = TE.simulate(_port_workflow(wf), eet.eet, power, mtype,
                     policy=policy, device="cpu")
    for group, name in FIELDS[:10] + FIELDS[12:13]:
        a = getattr(sj if group is None else getattr(sj, group), name)
        b = getattr(st if group is None else getattr(st, group), name)
        _same(np.asarray(a), b[0].numpy(), f"{name} {policy}")


# ---------------------------------------------------------------------------
# reference engine
# ---------------------------------------------------------------------------
def _refs(eet, power, wf, mtype, policy):
    wl, rank = wf.workload, wf.ranks(eet.eet.mean(1))
    args = (wl.arrival, wl.type_id, wl.deadline, eet.eet, power, mtype)
    kw = dict(policy=policy, parents=wf.parents, rank=rank)
    return R.simulate_ref(*args, **kw), TR.simulate_ref(*args, **kw)


def _same_ref(a, b, what):
    for col in ("status", "machine", "t_start", "t_end", "active_energy",
                "active_time"):
        _same(getattr(a, col), getattr(b, col), f"{col} {what}")
    assert a.makespan == b.makespan and a.n_events == b.n_events, what


@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_ref_parents_equals_jax(policy):
    for seed, slack in ((2, 4.0), (9, 1.8), (31, 3.0)):
        eet, power, wf, mtype = make_dag_instance(seed, slack=slack,
                                                  slack_jitter=0.3)
        _same_ref(*_refs(eet, power, wf, mtype, policy),
                  f"seed={seed} {policy}")
    _same_ref(*_refs(*_cascade_instance()[:4], policy), f"cascade {policy}")


# the instances on which the JAX engine and the JAX oracle disagree on
# `machine` (ROADMAP.md, queue C): tests/test_workflows.py's property test
# under slack_jitter=0.3
ORACLE_FAULTS = ((8205, "heft", 2.0), (8104, "heft", 2.0),
                 (6683, "minmin", 3.0), (6887, "heft", 2.0))


@pytest.mark.parametrize("seed,policy,slack", ORACLE_FAULTS)
def test_reference_engine_oracle_disagreement(seed, policy, slack):
    """Each side of the port equals its JAX counterpart, where the JAX
    engine and the JAX oracle disagree with each other."""
    eet, power, wf, mtype = make_dag_instance(seed, slack=slack,
                                              slack_jitter=0.3)
    sj = E.simulate(wf, eet, power, mtype, policy=policy)
    st = TE.simulate(_port_workflow(wf), eet.eet, power, mtype,
                     policy=policy, device="cpu")
    for group, name in FIELDS[:10] + FIELDS[12:13]:
        a = getattr(sj if group is None else getattr(sj, group), name)
        b = getattr(st if group is None else getattr(st, group), name)
        _same(np.asarray(a), b[0].numpy(), f"engine {name}")
    jref, tref = _refs(eet, power, wf, mtype, policy)
    _same_ref(jref, tref, "oracle")
    assert (np.asarray(sj.tasks.machine) != jref.machine).any()
