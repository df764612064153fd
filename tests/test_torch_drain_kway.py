"""The port's K-way drain and legacy drain against its sequential drain
and the JAX package.

Tolerance 0 throughout.  ``SimParams(drain_k=K)`` must give the bitwise
final state of the port's one-decision drain, and of the JAX engine's
``drain_k=K``, for all ten policies on one batch that holds a flat
instance, two dynamic-fleet instances (requeue and spot) and two
workflows (one with failures and DVFS): every row carries dynamics and a
parent table, inert on the flat rows, so one JAX executable covers them.
``legacy_drain`` must equal the JAX legacy loop and the port's drain; the
dense-batch case (every task at t = 0, ``lcap=12``) must stay bitwise at
K = 8 with fewer drain trips; and a fixed list of seeds stands in for the
JAX suite's hypothesis property.  The JAX K = 2 executable is held in
``tests/test_torch_drain_kway_k2.py`` (each K-way compile of the
reference takes some 20 s).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_instance
from test_workflows import make_dag_instance

from repro.core import engine as E
from repro.core import schedulers as P
from repro.core import workload as JW
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import schedulers as TP
from repro_torch.core import state as TS

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
FIELDS = (("tasks", "status"), ("tasks", "machine"), ("tasks", "seq"),
          ("tasks", "t_start"), ("tasks", "t_end"),
          ("machines", "running"), ("machines", "busy_until"),
          ("machines", "active_time"), ("machines", "energy"),
          (None, "time"), (None, "n_events"), (None, "seq_counter"),
          (None, "rr_ptr"), (None, "n_batch"), (None, "n_live"),
          (None, "mq_count"), (None, "n_preempts"))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def assert_bitwise(sa, sb, what, fields=FIELDS):
    """Every state field bitwise; either side JAX or the port."""
    def get(st, group, name):
        x = getattr(st if group is None else getattr(st, group), name)
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    for group, name in fields:
        _same(get(sa, group, name), get(sb, group, name), f"{name} {what}")


def mixed_batch():
    """All ten policies on five instances of 18 tasks and 3 machines,
    every row with dynamics and a parent table (K = 3): flat (static
    fleet, no edges), fail/repair and spot fleets (no edges), a layered
    DAG on a static fleet and one under failures + DVFS."""
    def static(wl, m):
        return JW.make_scenario(wl, m)

    rows = []
    eet, power, wl, mtype = make_instance(3, 18, 3)
    rows.append((eet, power, wl, mtype, static(wl, 3), None))
    for seed, spot in ((4, False), (5, True)):
        eet, power, wl, mtype = make_instance(seed, 18, 3, rate=4.0)
        rows.append((eet, power, wl, mtype, JW.make_scenario(
            wl, 3, fail_rate=0.25, mttr=2.0, spot=spot, dvfs="powersave",
            seed=seed), None))
    eet, power, wf, mtype = make_dag_instance(2)
    rows.append((eet, power, wf.workload, mtype, static(wf.workload, 3),
                 wf))
    eet, power, wf, mtype = make_dag_instance(3, slack=3.0)
    rows.append((eet, power, wf.workload, mtype, JW.make_scenario(
        wf.workload, 3, fail_rate=0.06, mttr=3.0, spot=False,
        dvfs="powersave", seed=3), wf))
    reps = []
    for eet, power, wl, mtype, scen, wf in rows:
        rank = None if wf is None else wf.ranks(eet.eet.mean(1))
        parents = np.full((wl.n_tasks, 3), -1, np.int32) if wf is None \
            else wf.parents
        tables = E.make_tables(eet, power, wl.n_tasks, rank=rank)
        for p in POLICIES:
            reps.append((wl.to_task_table(), jnp.asarray(mtype, jnp.int32),
                         tables, jnp.int32(P.POLICY_IDS[p]),
                         scen.dynamics(), jnp.asarray(parents)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *reps)


def jax_run(batch, params):
    return E.run_sweep(*batch[:4], params, batch[4], None, batch[5])


def port_run(batch, params, stats=None):
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    return TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                        params, stats, reps.dynamics, reps.parents)


def stacked_policy_batch(seed, n_tasks=24, n_machines=4, rate=3.0):
    """The JAX suite's instance: one fleet replicated over the ten
    policies, without dynamics or parents."""
    eet, power, wl, mtype = make_instance(seed, n_tasks, n_machines,
                                          rate=rate)
    tt, mt, tb = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (len(POLICIES),) + x.shape),
        (wl.to_task_table(), jnp.asarray(mtype, jnp.int32),
         E.make_tables(eet, power, wl.n_tasks)))
    pids = jnp.asarray([P.POLICY_IDS[p] for p in POLICIES], jnp.int32)
    return tt, mt, tb, pids, None, None


@pytest.fixture(scope="module")
def mixed():
    batch = mixed_batch()
    seq = port_run(batch, TE.SimParams(lcap=3))
    return batch, seq


# ---------------------------------------------------------------------------
# the order keys
# ---------------------------------------------------------------------------
def test_order_by_key_matches_jax_sort():
    """The speculation's stable (key, id) order equals the reference's
    ``jnp.argsort`` on keys that mix -0.0, +0.0, +-inf and ties, with
    fewer valid tasks than the width and fewer tasks than the width."""
    rng = np.random.default_rng(0)
    pool = np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 2.0],
                    np.float32)
    for n, k in ((12, 5), (30, 8), (3, 8)):
        keys = rng.choice(pool, (7, n)).astype(np.float32)
        valid = rng.random((7, n)) < 0.7
        valid[0] = False
        want = jax.vmap(lambda a, b: P._order_by_key(a, b, k))(
            jnp.asarray(keys), jnp.asarray(valid))
        got = TP._order_by_key(torch.as_tensor(keys), torch.as_tensor(valid),
                               k)
        _same(want, got.numpy(), f"n={n} k={k}")
        got = TP._order_by_key(-torch.as_tensor(keys), torch.as_tensor(
            valid), k)
        want = jax.vmap(lambda a, b: P._order_by_key(-a, b, k))(
            jnp.asarray(keys), jnp.asarray(valid))
        _same(want, got.numpy(), f"negated n={n} k={k}")
        ids = torch.arange(n, dtype=torch.float32).expand(7, n)
        _same(TP._order_by_key(ids, torch.as_tensor(valid), k).numpy(),
              TP._first_k(torch.as_tensor(valid), k).numpy(), "first_k")


# ---------------------------------------------------------------------------
# K-way == sequential == the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [2, 8])
def test_kway_bitwise_equals_sequential(mixed, k):
    batch, seq = mixed
    stats = TE.RunStats()
    kway = port_run(batch, TE.SimParams(lcap=3, drain_k=k), stats)
    assert_bitwise(kway, seq, f"k={k}")
    _same(kway.deps_left.numpy(), seq.deps_left.numpy(), "deps_left")


def test_sequential_matches_jax(mixed):
    batch, seq = mixed
    assert_bitwise(jax_run(batch, E.SimParams(lcap=3)), seq, "k=1")


def test_kway8_matches_jax(mixed):
    batch, _ = mixed
    assert_bitwise(jax_run(batch, E.SimParams(lcap=3, drain_k=8)),
                   port_run(batch, TE.SimParams(lcap=3, drain_k=8)), "k=8")


def test_legacy_drain_matches_jax_and_sequential():
    batch = stacked_policy_batch(5)
    legacy = port_run(batch, TE.SimParams(lcap=3, legacy_drain=True))
    assert_bitwise(jax_run(batch, E.SimParams(lcap=3, legacy_drain=True)),
                   legacy, "legacy")
    assert_bitwise(port_run(batch, TE.SimParams(lcap=3)), legacy,
                   "legacy vs hot")


def test_kway_dense_batch():
    """Every task arrives at t = 0 and the first drain schedules a deep
    queue: K = 8 stays bitwise, for all ten policies, and takes fewer
    drain trips."""
    eet, power, wl, mtype = make_instance(11, 48, 6, rate=1e9)
    wl.arrival = np.zeros_like(wl.arrival)
    tt, mt, tb = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (len(POLICIES),) + x.shape),
        (wl.to_task_table(), jnp.asarray(mtype, jnp.int32),
         E.make_tables(eet, power, wl.n_tasks)))
    batch = (tt, mt, tb, jnp.asarray([P.POLICY_IDS[p] for p in POLICIES],
                                     jnp.int32), None, None)
    s1, s8 = TE.RunStats(), TE.RunStats()
    seq = port_run(batch, TE.SimParams(lcap=12), s1)
    kway = port_run(batch, TE.SimParams(lcap=12, drain_k=8), s8)
    assert_bitwise(kway, seq, "dense k=8")
    assert_bitwise(jax_run(batch, E.SimParams(lcap=12)), seq, "dense k=1")
    assert s8.drain_trips < s1.drain_trips, (s8, s1)
    assert s8.events == s1.events


SEEDS = ((17, 1.5, 2), (901, 4.0, 3), (4242, 16.0, 8), (31337, 1.5, 8),
         (65000, 4.0, 2), (123, 16.0, 3))


@pytest.mark.parametrize("seed,rate,k", SEEDS)
def test_kway_fixed_seeds(seed, rate, k):
    """The JAX suite's property over a fixed list of (seed, rate, K)."""
    batch = stacked_policy_batch(seed, rate=rate)
    assert_bitwise(port_run(batch, TE.SimParams(lcap=3, drain_k=k)),
                   port_run(batch, TE.SimParams(lcap=3)),
                   f"seed={seed} rate={rate} k={k}")


def test_apply_decisions_k_advances_counters():
    """One K-way trip applies its prefix: sequence numbers in candidate
    order, ``rr_ptr`` past the last mapped machine, counters moved."""
    batch = stacked_policy_batch(8, rate=1e9)
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    st = TS.init_state(reps.tasks, reps.mtype)
    st.tasks.status[:] = TS.IN_BATCH
    st.n_batch[:] = st.tasks.status.shape[1]
    plan = TP.Plan.make(reps.policy_ids, st, reps.tables)
    const = TP.expected_tables(st, reps.tables)
    dec, use, _ = TP.dispatch_k(plan, st, reps.tables, 3, True, 4, const)
    n = TE._apply_decisions_k(st, dec, use)
    assert bool((n == use.sum(1)).all()) and bool((n >= 1).all())
    mapped = use & ~dec.cancel
    assert bool((st.seq_counter == mapped.sum(1)).all())
    assert bool((st.mq_count.sum(1) == mapped.sum(1)).all())
