"""The port's trace capture against the JAX engine's, row by row.

Tolerance 0.  One batch holds all ten policies on a flat instance, two
dynamic-fleet instances (requeue and spot kill) and two workflows (one
under failures and DVFS), every row with dynamics and a parent table
(``test_torch_drain_kway.mixed_batch``).  With ``trace=True`` and
``metrics=True``, every replica's transition rows must equal the JAX
``run_sweep``'s position by position (time bits, kind, task, machine,
and ``n_rows``), its snapshot arrays must be bitwise equal, and its
metrics counts equal; with the reference's Pallas kernels off and on,
in the legacy drain, and with a capacity too small (the overflow case).
Tracing must not perturb the run: final states, ``RunStats`` and the
host reads made by the loop are those of the run without it.  The
K-way drains are held in ``tests/test_torch_trace_kway.py`` and
``tests/test_torch_metrics.py`` (each K-way compile of the reference
takes some 20 s).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_torch_drain_kway import (POLICIES, assert_bitwise, jax_run,
                                   mixed_batch, port_run)

from repro.core import engine as E
from repro.core import metrics as JM
from repro.core import trace as JT
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import metrics as TM
from repro_torch.core import state as TS
from repro_torch.core import trace as TT

pytestmark = pytest.mark.torch

SNAPSHOTS = ("snap_time", "snap_batch", "snap_mq", "snap_running",
             "snap_energy")


def _bits(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def assert_trace_equal(sj, st, rows, what):
    """The port's trace (``st.trace``) equals the trace of ``sj`` (a JAX
    or port state) on replicas ``rows``: the same ``n_rows`` and
    capacity, the valid rows position by position, every snapshot array
    bitwise."""
    jt, pt = sj.trace, st.trace
    assert jt.cap == pt.cap, what
    for i in rows:
        j1 = TT.replica_trace(jt, i) if isinstance(jt, TT.TraceBuffer) \
            else jax.tree.map(lambda x: np.asarray(x)[i], jt)
        p1 = TT.replica_trace(pt, i)
        assert int(j1.n_rows) == int(p1.n_rows), f"n_rows {what} r={i}"
        je, pe = JT.events(j1), TT.events(p1)
        for key in ("time", "kind", "task", "machine"):
            a, b = je[key], pe[key]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, what)
            bad = np.nonzero(a.view(np.int32) != b.view(np.int32))[0]
            assert bad.size == 0, (
                f"{what} replica {i}: row {bad[0]} {key} {a[bad[0]]} != "
                f"{b[bad[0]]}")
    for f in SNAPSHOTS:
        a = np.asarray(getattr(jt, f))[rows]
        b = getattr(pt, f).numpy()[rows]
        assert a.dtype == b.dtype and a.shape == b.shape, (f, what)
        assert _bits(a) == _bits(b), f"{f} {what}"


def assert_counts_equal(sj, st, what):
    for f in JM.SimMetrics._FIELDS:
        a = np.asarray(getattr(sj.metrics, f))
        b = getattr(st.metrics, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{f} {what}"


def traced(**kw) -> tuple[E.SimParams, TE.SimParams]:
    return (E.SimParams(lcap=3, trace=True, metrics=True, **kw),
            TE.SimParams(lcap=3, trace=True, metrics=True, **kw))


def rows_of(policy, n_rows):
    return [r for r in range(n_rows)
            if r % len(POLICIES) == POLICIES.index(policy)]


@pytest.fixture(scope="module")
def batch():
    return mixed_batch()


@pytest.fixture(scope="module")
def k1(batch):
    """The JAX and port runs at K = 1, traced, with the port's RunStats
    and its untraced run."""
    jp, tp = traced()
    stats, plain_stats = TE.RunStats(), TE.RunStats()
    return (jax_run(batch, jp), port_run(batch, tp, stats), stats,
            port_run(batch, TE.SimParams(lcap=3), plain_stats),
            plain_stats)


@pytest.mark.parametrize("policy", POLICIES)
def test_trace_rows_match_jax(k1, policy):
    sj, st, *_ = k1
    rows = rows_of(policy, st.n_events.shape[0])
    assert_trace_equal(sj, st, rows, f"policy={policy}")
    assert not any(TT.overflowed(TT.replica_trace(st.trace, i))
                   for i in rows)


def test_metrics_counts_match_jax(k1):
    sj, st, *_ = k1
    assert_counts_equal(sj, st, "k=1")


def test_trace_does_not_perturb_the_run(k1):
    _, st, stats, plain, plain_stats = k1
    assert_bitwise(st, plain, "trace+metrics on vs off")
    assert plain.trace is None and plain.metrics is None
    assert stats == plain_stats, (stats, plain_stats)


def test_trace_reads_nothing_more_from_the_host(batch, monkeypatch):
    """Tracing and metrics add no device-to-host read to the loop: the
    conversions a run makes (``bool``, ``item``, ``tolist``, ``cpu``,
    ``numpy``) number the same with them on and off."""
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    counts = {}
    for name in ("__bool__", "item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)

    def run(params):
        counts.clear()
        TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                     params, None, reps.dynamics, reps.parents)
        return dict(counts)

    assert run(traced()[1]) == run(TE.SimParams(lcap=3))


@pytest.mark.parametrize("variant", ["pallas", "legacy", "overflow"])
def test_trace_variants_match_jax(batch, variant):
    """The reference with its Pallas kernels (interpret mode), the
    legacy drain, and a capacity of 12 rows, which every replica
    overflows: the kept rows are the first 12 and ``n_rows`` counts on."""
    kw = {"pallas": {}, "legacy": {"legacy_drain": True},
          "overflow": {"trace_capacity": 12}}[variant]
    jp, tp = traced(**kw)
    if variant == "pallas":
        jp = jp._replace(pallas=True)
    sj, st = jax_run(batch, jp), port_run(batch, tp)
    n = st.n_events.shape[0]
    assert_trace_equal(sj, st, range(n), variant)
    assert_counts_equal(sj, st, variant)
    assert_bitwise(sj, st, variant)
    if variant == "overflow":
        assert all(TT.overflowed(TT.replica_trace(st.trace, i))
                   for i in range(n))
        assert all(TT.events(TT.replica_trace(st.trace, i))["time"].size
                   == 12 for i in range(n))


def test_trace_accounts_for_every_task(k1):
    """Per replica: the terminal rows number N, every start row opens a
    segment that a later row of its task closes (a preempt or requeue
    row of a queued task closes none), and the segments tile each
    machine's active time."""
    _, st, *_ = k1
    n = st.tasks.status.shape[1]
    terminal = (TT.EV_COMPLETE, TT.EV_PREEMPT, TT.EV_MISS_QUEUE,
                TT.EV_MISS_RUNNING, TT.EV_CANCEL)
    for i in range(st.n_events.shape[0]):
        tb = TT.replica_trace(st.trace, i)
        kind = TT.events(tb)["kind"]
        assert np.isin(kind, terminal).sum() == n, i
        segs = TT.segments(tb)
        assert len(segs) == (kind == TT.EV_START).sum(), i
        assert len(segs) <= np.isin(kind, TT.SEGMENT_CLOSERS).sum(), i
        per_m = np.zeros(st.machines.mtype.shape[1])
        for s in segs:
            assert s["outcome"] is not None
            per_m[s["machine"]] += s["t1"] - s["t0"]
        np.testing.assert_allclose(per_m, st.machines.active_time[i].numpy(),
                                   rtol=1e-4, atol=1e-3)


def test_record_appends_in_mask_order_and_drops_past_capacity():
    """Two replicas, capacity 3: rows land in mask order after the
    earlier rows, ``kind`` and ``machine`` aligned with the mask's
    columns; the fourth row of replica 0 is dropped while ``n_rows``
    counts it."""
    tb = TT.make_buffer(2, 3, 4, 2, "cpu")
    TT.record(tb, torch.tensor([1.0, 2.0]), TT.EV_START,
              torch.tensor([[5, 6, 7], [8, 9, 10]], dtype=torch.int32), -1,
              torch.tensor([[True, False, True], [False, True, False]]))
    TT.record(tb, torch.tensor([3.0, 4.0]),
              torch.tensor([TT.EV_COMPLETE, TT.EV_CANCEL]),
              torch.tensor([1, 2], dtype=torch.int32).expand(2, 2),
              torch.tensor([0, 1]), torch.ones(2, 2, dtype=torch.bool))
    assert tb.n_rows.tolist() == [4, 3]
    e0 = TT.events(TT.replica_trace(tb, 0))
    assert e0["task"].tolist() == [5, 7, 1]
    assert e0["kind"].tolist() == [TT.EV_START, TT.EV_START, TT.EV_COMPLETE]
    assert e0["time"].tolist() == [1.0, 1.0, 3.0]
    e1 = TT.events(TT.replica_trace(tb, 1))
    assert e1["task"].tolist() == [9, 1, 2]
    assert e1["kind"].tolist() == [TT.EV_START, TT.EV_COMPLETE,
                                   TT.EV_CANCEL]
    assert e1["machine"].tolist() == [-1, 0, 1]
    assert TT.overflowed(TT.replica_trace(tb, 0))
    assert not TT.overflowed(TT.replica_trace(tb, 1))


def test_capacity_bound_and_accessors_match_jax(k1):
    """``row_capacity_bound`` equals the reference's; ``snapshots`` and
    ``segments`` of one replica equal the JAX accessors' output, and a
    state resolves to its replica with its event count."""
    sj, st, *_ = k1
    for args in ((18, 3, 3, 4), (1024, 4, 32, 4), (7, 1)):
        assert TT.row_capacity_bound(*args) == JT.row_capacity_bound(*args)
    for i in (0, 17, 45):
        j1 = jax.tree.map(lambda x: np.asarray(x)[i], sj.trace)
        p1 = TT.replica_trace(st.trace, i)
        n = int(st.n_events[i])
        for key, a in JT.snapshots(j1, n).items():
            assert _bits(a) == _bits(TT.snapshots(p1, n)[key]), key
        for key, a in JT.snapshots(j1).items():
            assert _bits(a) == _bits(TT.snapshots(p1)[key]), key
        assert JT.segments(j1) == TT.segments(p1)
        tb, n_ev = TT.resolve(st, i)
        assert n_ev == n and int(tb.n_rows) == int(p1.n_rows)
    with pytest.raises(ValueError, match="no trace"):
        TT.resolve(k1[3])
    with pytest.raises(ValueError, match="replica_trace"):
        TT.events(st.trace)


def test_take_slices_trace_and_metrics(k1):
    _, st, *_ = k1
    one = st.take(slice(3, 5))
    assert isinstance(one.trace, TT.TraceBuffer) and one.trace.cap == \
        st.trace.cap
    assert torch.equal(one.trace.ev_task, st.trace.ev_task[3:5])
    assert torch.equal(one.metrics.response, st.metrics.response[3:5])
    assert one.metrics.spec == st.metrics.spec
    assert isinstance(one.metrics, TM.SimMetrics)
    assert TS.SimState.__dataclass_fields__["trace"].default is None
