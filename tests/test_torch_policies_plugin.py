"""User-registered policies in the port (the paper's feature (ii)).

The cases of ``tests/test_policies_plugin.py`` on the port's registry:
``register_policy`` round-trips through ``simulate``, mixed ids in one
sweep take each replica's own policy, and a name already registered
(built-ins included) raises.  Beyond them: a torch re-implementation of
``mct`` registered under a new id sweeps bitwise like the JAX built-in
``mct`` (the JAX registry is never touched: other JAX files on the same
worker read it); a user policy's machine pick joins the one shared
``masked_argmin`` call of a drain trip; at ``drain_k`` 2 and 8 a sweep
with user policies is bitwise its K = 1 run; a user policy may return a
``Decision``; ``mlp`` and ``linear`` still raise.  Every test restores
the port's registry with ``monkeypatch``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_policies_plugin import N_MACHINES, N_TASKS, _instance
from test_torch_drain_kway import (assert_bitwise, mixed_batch, port_run)

from repro.core import engine as E
from repro.core import schedulers as P
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import schedulers as TP
from repro_torch.core.eet import EETTable
from repro_torch.core.workload import Workload
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

BIG = 1e30


@pytest.fixture
def registry(monkeypatch):
    """The port's registry, restored after the test."""
    monkeypatch.setattr(TP, "SCHEDULERS", dict(TP.SCHEDULERS))
    monkeypatch.setattr(TP, "POLICY_NAMES", list(TP.POLICY_NAMES))
    monkeypatch.setattr(TP, "POLICY_IDS", dict(TP.POLICY_IDS))
    jax_before = list(P.POLICY_NAMES)
    yield TP
    assert P.POLICY_NAMES == jax_before


def lowest_id(state, view):
    """Head task to the lowest-id machine with room."""
    n_m = view.room.shape[1]
    scores = torch.arange(n_m, dtype=torch.float32).expand(view.room.shape)
    return view.head, scores, view.room


def lowest_id_decision(state, view):
    """The same policy returning a ``Decision``."""
    ids = torch.arange(view.room.shape[1], dtype=torch.int32)
    m = torch.where(view.room, ids, view.room.shape[1]).amin(1)
    ok = (view.head >= 0) & view.any_room
    return TP.Decision(torch.where(ok, view.head, -1),
                       torch.where(ok, m, -1).to(torch.int32),
                       torch.zeros_like(ok))


def torch_mct(state, view):
    """Minimum expected completion time for the head task."""
    scores = torch.where((view.head >= 0)[:, None],
                         view.avail + view.row(view.eet_nm, view.head), BIG)
    return view.head, scores, view.room


def _port_instance(seed):
    eet, power, wl, mtype = _instance(seed)
    return (EETTable(eet.eet), power,
            Workload(wl.arrival, wl.type_id, wl.deadline), mtype)


def test_register_roundtrip_single_run(registry):
    pid = registry.register_policy("lowest_id", lowest_id)
    assert pid == 12 == registry.POLICY_IDS["lowest_id"]
    assert registry.POLICY_NAMES[pid] == "lowest_id"
    eet, power, wl, mtype = _port_instance(0)
    st = TE.simulate(wl, eet, power, mtype, policy="lowest_id",
                     cancel_infeasible=False, lcap=N_TASKS, device="cpu")
    machine = st.tasks.machine[0].numpy()
    mapped = machine >= 0
    assert mapped.any() and (machine[mapped] == 0).all(), machine
    assert (st.tasks.status >= 4).all()
    assert registry.register_policy("second", lowest_id) == 13


def test_duplicate_registration_raises(registry):
    registry.register_policy("dup_policy", lowest_id)
    with pytest.raises(ValueError, match="already registered"):
        registry.register_policy("dup_policy", lowest_id)
    for name in ("mct", "minmin", "mlp"):
        with pytest.raises(ValueError, match="already registered"):
            registry.register_policy(name, lowest_id)


def _jax_stack(seed, pids):
    eet, power, wl, mtype = _instance(seed)
    tables = E.make_tables(eet, power, wl.n_tasks)
    k = len(pids)
    stack = lambda x: jax.tree.map(  # noqa: E731
        lambda a: jnp.broadcast_to(jnp.asarray(a),
                                   (k,) + jnp.asarray(a).shape), x)
    return (stack(wl.to_task_table()), stack(jnp.asarray(mtype, jnp.int32)),
            stack(tables), jnp.asarray(pids, jnp.int32))


def _port_sweep(batch, pids, params, stats=None):
    reps = interop.replicas_from_numpy(*batch[:3], np.asarray(pids),
                                       device="cpu")
    return TE.run_sweep(reps.tasks, reps.mtype, reps.tables,
                        reps.policy_ids, params, stats)


def test_custom_id_in_a_mixed_sweep(registry):
    """Mixed ids in one sweep: the user replicas map to machine 0 only,
    the mct and fcfs replicas equal the JAX built-ins bitwise."""
    uid = registry.register_policy("lowest_id2", lowest_id)
    jp = [P.POLICY_IDS["mct"], P.POLICY_IDS["fcfs"]]
    batch = _jax_stack(3, [jp[0], jp[0], jp[0], jp[1]])
    params = TE.SimParams(lcap=N_TASKS, cancel_infeasible=False)
    st = _port_sweep(batch, [uid, jp[0], uid, jp[1]], params)
    machine = st.tasks.machine.numpy()
    for i in (0, 2):
        assert (machine[i][machine[i] >= 0] == 0).all(), machine[i]
    want = E.run_sweep(*batch, E.SimParams(lcap=N_TASKS,
                                           cancel_infeasible=False))
    rows = torch.tensor([1, 3])
    assert_bitwise(jax.tree.map(lambda x: x[np.array([1, 3])], want),
                   st.take(rows), "mct/fcfs beside a user policy")


@pytest.mark.parametrize("seed", [0, 3])
def test_registered_mct_sweeps_like_jax_builtin_mct(registry, seed):
    """A torch re-implementation of ``mct`` under id 12 against the JAX
    built-in ``mct``, with and without the cancellation wrapper."""
    uid = registry.register_policy("torch_mct", torch_mct)
    for ci in (True, False):
        batch = _jax_stack(seed, [P.POLICY_IDS["mct"]] * 3)
        want = E.run_sweep(*batch, E.SimParams(lcap=3,
                                               cancel_infeasible=ci))
        got = _port_sweep(batch, [uid] * 3, TE.SimParams(
            lcap=3, cancel_infeasible=ci))
        assert_bitwise(want, got, f"seed={seed} cancel={ci}")


def test_user_pick_joins_the_shared_masked_argmin(registry, monkeypatch):
    """One ``masked_argmin`` call a drain trip for mct, ee_mct and a
    user policy together."""
    uid = registry.register_policy("lowest_id3", lowest_id)
    calls = []
    orig = TP.K.masked_argmin

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)
    monkeypatch.setattr(TP.K, "masked_argmin", counted)
    batch = _jax_stack(1, [0, 0, 0])
    stats = TE.RunStats()
    _port_sweep(batch, [uid, P.POLICY_IDS["mct"], P.POLICY_IDS["ee_mct"]],
                TE.SimParams(lcap=3), stats)
    assert len(calls) == stats.drain_trips
    assert all(s == (3, 1, N_MACHINES) for s in calls)


@pytest.mark.parametrize("k", [2, 8])
def test_user_policies_kway_bitwise_k1(registry, k):
    """All ten built-ins plus two user policies (immediate and
    ``Decision`` forms) on flat, dynamic-fleet and workflow instances:
    the K-way drain is bitwise the one-decision drain."""
    a = registry.register_policy("lowest_id4", lowest_id)
    b = registry.register_policy("lowest_dec", lowest_id_decision)
    c = registry.register_policy("torch_mct2", torch_mct)
    batch = list(mixed_batch())
    pids = np.asarray(batch[3]).copy()
    pids[pids == P.POLICY_IDS["fcfs"]] = a
    pids[pids == P.POLICY_IDS["met"]] = b
    pids[pids == P.POLICY_IDS["ee_met"]] = c
    batch[3] = jnp.asarray(pids)
    one = port_run(batch, TE.SimParams(lcap=3))
    assert_bitwise(port_run(batch, TE.SimParams(lcap=3, drain_k=k)), one,
                   f"user policies k={k}")
    # each instance holds every policy: the two lowest-id forms agree,
    # and torch_mct equals the built-in mct on the same instances
    def rows(pid):
        return torch.as_tensor(np.nonzero(pids == pid)[0])
    assert_bitwise(one.take(rows(a)), one.take(rows(b)), "Decision form")
    assert_bitwise(one.take(rows(c)), one.take(rows(P.POLICY_IDS["mct"])),
                   "torch_mct vs mct")


def test_user_policy_through_run_experiment(registry):
    uid = registry.register_policy("lowest_id5", lowest_id)
    spec = TX.ExperimentSpec(
        6, TX.FleetAxis(3), TX.WorkloadAxis(16),
        policy=TX.PolicyAxis(("mct", "lowest_id5", "minmin")), seed=2)
    res = TX.run_experiment(spec, device="cpu")
    assert res.replicas.policy_ids.tolist() == [3, uid, 6] * 2
    rows = {r["policy"]: r["replicas"] for r in res.by_policy()}
    assert rows == {"mct": 2, "lowest_id5": 2, "minmin": 2}


def test_learned_policies_still_raise(registry):
    """The learned policies keep their built-in ids beside a registered
    user policy and run, bitwise the JAX sweep with the same stacked
    weights (tolerance 0); an unknown id still raises."""
    from repro.core import neural as JN
    uid = registry.register_policy("lowest_id6", lowest_id)
    ids = [P.POLICY_IDS["mlp"], P.POLICY_IDS["linear"]]
    batch = _jax_stack(0, ids + [P.POLICY_IDS["mct"]])
    pp = jax.tree.map(lambda *x: jnp.stack(x),
                      *[JN.init_params(s) for s in (0, 3, 7)])
    want = E.run_sweep(*batch, policy_params=pp)
    reps = interop.replicas_from_numpy(*batch[:3], np.asarray(ids + [uid]),
                                       device="cpu")
    st = TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                      policy_params=interop.policy_params_from_numpy(
                          JN.params_to_numpy(pp), "cpu"))
    assert_bitwise(jax.tree.map(lambda x: x[np.array([0, 1])], want),
                   st.take(torch.tensor([0, 1])), "mlp/linear beside a "
                   "user policy")
    with pytest.raises(ValueError, match="unknown policy id"):
        _port_sweep(batch, [99], TE.SimParams())
