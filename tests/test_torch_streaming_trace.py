"""The port's streaming engine with trace and metrics, at ``drain_k=2``,
against its oracle, and its report row.

Tolerance 0 against the JAX streaming engine: with ``trace=True,
metrics=True`` on the mixed batch of ``tests/test_torch_streaming.py``
(failure, spot and DVFS fleets, a chain and two fork-joins), every
replica's transition rows (slot ids globalized), ``n_rows``, snapshots
(running ids globalized) and histogram and window counts; at
``drain_k=2`` on the plain batch every window field, and the port's
K = 2 run bitwise its K = 1 run.  ``report.summarize_stream`` must equal
the reference's row.  The port's ``simulate_ref(window=W)`` must equal
the JAX oracle's, and the port's streaming engine must agree with it at
the tolerances of ``tests/test_streaming.py`` (counts exact, makespan
1e-5, energy 1e-4, trace rows equal with times within 1e-3), including a
DAG whose dependency frontier exceeds the window.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from conftest import make_instance
from test_torch_streaming import (AGG_FIELDS, POLICIES, W, _np, _same,
                                  assert_window_equal,
                                  jax_stream, mixed_instances,
                                  plain_instances, port_params, port_stream,
                                  stream_batch)

from repro.core import metrics as JM
from repro.core import ref_engine as JR
from repro.core import report as JREP
from repro.core import state as JS
from repro.core import streaming as ST
from repro.core import trace as JT
from repro.core import workload as JW
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import ref_engine as TR
from repro_torch.core import report as TREP
from repro_torch.core import streaming as TST
from repro_torch.core import trace as TT
from repro_torch.core import workload as TW

pytestmark = pytest.mark.torch

SNAPSHOTS = ("snap_time", "snap_batch", "snap_mq", "snap_running",
             "snap_energy")
MIXED_SIZES = (20, 12, 24, 20, 30, 12, 26)


@pytest.fixture(scope="module")
def traced_runs():
    batch = stream_batch(mixed_instances(), 6, dynamics=True, edges=True)
    params = ST.StreamParams(window=W, lcap=3, trace=True, metrics=True)
    stats, plain_stats = TE.RunStats(), TE.RunStats()
    traced = port_stream(batch, params, stats)
    plain = port_stream(batch, params._replace(trace=False, metrics=False),
                        plain_stats)
    return batch, jax_stream(batch, params), traced, stats, plain, \
        plain_stats


@pytest.mark.parametrize("policy", POLICIES)
def test_trace_rows_bitwise_jax(traced_runs, policy):
    _, wj, wt, *_ = traced_runs
    jt, pt = wj.sim.trace, wt.sim.trace
    assert jt.cap == pt.cap
    n_rep = pt.n_rows.shape[0]
    for i in range(POLICIES.index(policy), n_rep, len(POLICIES)):
        j1 = jax.tree.map(lambda x: np.asarray(x)[i], jt)
        p1 = TT.replica_trace(pt, i)
        assert int(j1.n_rows) == int(p1.n_rows) <= pt.cap, i
        je, pe = JT.events(j1), TT.events(p1)
        for key in ("time", "kind", "task", "machine"):
            _same(je[key], pe[key], f"{key} replica {i}")
        n = MIXED_SIZES[i // len(POLICIES)]
        assert set(pe["task"].tolist()) <= set(range(n)), i
    for f in SNAPSHOTS:
        _same(getattr(jt, f), getattr(pt, f), f)


def test_metrics_counts_bitwise_jax(traced_runs):
    _, wj, wt, *_ = traced_runs
    for f in JM.SimMetrics._FIELDS:
        _same(getattr(wj.agg.metrics, f), getattr(wt.agg.metrics, f), f)
    done = wt.agg.completed
    assert torch.equal(wt.agg.metrics.response.sum(1, dtype=torch.int32),
                       done)
    assert torch.equal(wt.agg.metrics.queue_depth.sum(1, dtype=torch.int32),
                       wt.sim.n_events)


def test_trace_does_not_perturb_the_window(traced_runs):
    """Trace and metrics read the state only: the same final window, the
    same loop counters and host reads as the plain run."""
    _, wj, wt, stats, plain, plain_stats = traced_runs
    assert_window_equal(wj, wt, "traced", sums_close=True)
    for f in AGG_FIELDS:
        _same(getattr(wt.agg, f), getattr(plain.agg, f), f)
    for f in ("status", "machine", "t_start", "t_end"):
        _same(getattr(wt.sim.tasks, f), getattr(plain.sim.tasks, f), f)
    assert stats == plain_stats


def test_drain_k2_bitwise_jax_and_k1():
    batch = stream_batch(plain_instances(), 8, dynamics=False, edges=False)
    params = ST.StreamParams(window=W, lcap=3, drain_k=2)
    stats2, stats1 = TE.RunStats(), TE.RunStats()
    wt = port_stream(batch, params, stats2)
    assert_window_equal(jax_stream(batch, params), wt, "drain_k=2")
    w1 = port_stream(batch, params._replace(drain_k=1), stats1)
    assert_window_equal(w1, wt, "K = 2 against K = 1")
    assert stats2.drain_trips <= stats1.drain_trips


def _result(lib, ws, i, n, params, dyn, eet, power, mtype):
    """Replica ``i`` of a batched final window as a ``StreamResult``."""
    if lib is ST:
        one = jax.tree.map(lambda x: x[i], ws)
        d = None if dyn is None else jax.tree.map(lambda x: x[i], dyn)
        return ST.StreamResult(one, n, params, d, eet, power, mtype)
    d = None if dyn is None else interop.dynamics_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[i:i + 1], dyn), "cpu")
    return TST.StreamResult(ws.take(slice(i, i + 1)), n,
                            port_params(params), d, eet, power, mtype)


@pytest.mark.parametrize("replica", [3, 17, 26, 38])
def test_report_row_matches_jax(traced_runs, replica):
    """The report row of a dynamic-fleet replica (counts, energies,
    availability, tails and SLO rates) equals the reference's."""
    batch, wj, wt, *_ = traced_runs
    s, mt, e, p, _, dyn = batch
    params = ST.StreamParams(window=W, lcap=3, trace=True, metrics=True)
    n = MIXED_SIZES[replica // len(POLICIES)]
    args = (n, params, dyn, np.asarray(e[replica]), np.asarray(p[replica]),
            np.asarray(mt[replica]))
    want = JREP.summarize_stream(_result(ST, wj, replica, *args))
    got = TREP.summarize_stream(_result(TST, wt, replica, *args))
    assert want.keys() == got.keys()
    for k in want:
        if k in ("mean_response_s", "mean_wait_s"):
            # the retire sums: queue C (this batch runs in workflow mode)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)
        else:
            assert got[k] == want[k], k
    assert got["retired"] == n and not got["stalled"]


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------
def _ref_pair(wl, eet, power, mtype, policy, window, **kw):
    a = JR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet, power,
                        mtype, policy=policy, lcap=3, window=window, **kw)
    b = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet, power,
                        mtype, policy=policy, lcap=3, window=window, **kw)
    return a, b


def _assert_ref_equal(a, b, what):
    for f in ("status", "machine", "t_start", "t_end", "active_energy",
              "active_time"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{f} {what}")
    assert a.makespan == b.makespan and a.n_events == b.n_events, what


@pytest.mark.parametrize("policy", POLICIES)
def test_ref_window_mirror_equals_jax_oracle(policy):
    eet, power, wl, mtype = make_instance(7, n_tasks=60, rate=5.0)
    for window in (6, 60):
        a, b = _ref_pair(wl, eet, power, mtype, policy, window)
        _assert_ref_equal(a, b, f"{policy} W={window}")
    dense = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                            power, mtype, policy=policy, lcap=3)
    np.testing.assert_array_equal(b.t_end, dense.t_end)


@pytest.mark.parametrize("shape", ["chain", "fork_join", "stalled"])
def test_ref_window_mirror_workflows_equal_jax_oracle(shape):
    eet, power, _, mtype = make_instance(7)
    if shape == "chain":
        wf = JW.chain_workflow(30, 3, mean_eet=eet.eet.mean(1),
                               slack_jitter=0.4, seed=9)
        window = 6
    else:
        wf = JW.fork_join_workflow(6, 1, 3, mean_eet=eet.eet.mean(1),
                                   seed=10)
        window = ST.min_window(wf.parents) + (4 if shape == "fork_join"
                                              else -4)
    wl = wf.workload
    kw = dict(parents=wf.parents, rank=wf.ranks(eet.eet.mean(1)))
    a, b = _ref_pair(wl, eet, power, mtype, "heft", window, **kw)
    _assert_ref_equal(a, b, shape)
    stranded = int((b.status == JS.NOT_ARRIVED).sum())
    assert (stranded > 0) == (shape == "stalled")


def _port_simulate(wf_or_wl, eet, power, mtype, policy, **kw):
    if isinstance(wf_or_wl, JW.Workflow):
        wl = wf_or_wl.workload
        arg = TW.Workflow(TW.Workload(wl.arrival, wl.type_id, wl.deadline),
                          wf_or_wl.parents)
    else:
        wl = wf_or_wl
        arg = TW.Workload(wl.arrival, wl.type_id, wl.deadline)
    return TST.simulate_stream(arg, eet.eet, power, mtype, policy, lcap=3,
                               device="cpu", **kw)


def _trace_rows(tb):
    ev = TT.events(TT.replica_trace(tb, 0))
    return list(zip(ev["time"].tolist(), ev["kind"].tolist(),
                    ev["task"].tolist(), ev["machine"].tolist()))


@pytest.mark.parametrize("policy", ["fcfs", "mct", "minmin"])
def test_overflow_matches_port_oracle(policy):
    """N = 60 through W = 6: the counts exactly, the makespan and energy
    closely, the trace rows row by row (the oracle runs in float64)."""
    eet, power, wl, mtype = make_instance(7, n_tasks=60, rate=5.0)
    res = _port_simulate(wl, eet, power, mtype, policy, window=6, chunk=7,
                         trace=True)
    ref = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                          power, mtype, policy=policy, lcap=3, window=6)
    s = res.summarize()
    assert s["retired"] == 60 and not res.stalled
    assert s["completed"] == int((ref.status == JS.COMPLETED).sum())
    assert s["cancelled"] == int((ref.status == JS.CANCELLED).sum())
    assert s["missed"] == int(np.isin(ref.status, (JS.MISSED_QUEUE,
                                                   JS.MISSED_RUNNING)).sum())
    np.testing.assert_allclose(s["makespan"], ref.makespan, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(s["active_energy_J"], ref.active_energy.sum(),
                               rtol=1e-4, atol=1e-2)
    assert res.n_events == ref.n_events
    jref = JR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                           power, mtype, policy=policy, lcap=3, window=6,
                           trace=True)
    rows = _trace_rows(res.trace)
    assert len(rows) == len(jref.trace)
    for got, want in zip(rows, jref.trace):
        assert got[1:] == want[1:]
        assert abs(got[0] - want[0]) < 1e-3


def test_overflow_workflow_matches_port_oracle():
    eet, power, _, mtype = make_instance(7)
    wf = JW.chain_workflow(30, 3, mean_eet=eet.eet.mean(1),
                           slack_jitter=0.4, seed=9)
    wl = wf.workload
    res = _port_simulate(wf, eet, power, mtype, "heft", window=6, chunk=5)
    ref = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                          power, mtype, policy="heft", lcap=3,
                          parents=wf.parents,
                          rank=wf.ranks(eet.eet.mean(1)), window=6)
    s = res.summarize()
    assert s["retired"] == wl.n_tasks and not res.stalled
    assert s["completed"] == int((ref.status == JS.COMPLETED).sum())
    np.testing.assert_allclose(s["makespan"], ref.makespan, rtol=1e-5,
                               atol=1e-4)


def test_frontier_overflow_stalls_cleanly():
    """A DAG whose dependency frontier exceeds W stops with the stalled
    flag, not by burning its event budget, and the oracle strands the
    same unloadable tasks; a window large enough clears the stall."""
    eet, power, _, mtype = make_instance(7)
    wf = JW.fork_join_workflow(6, 1, 3, mean_eet=eet.eet.mean(1), seed=10)
    wl = wf.workload
    w = TST.min_window(wf.parents) - 4
    res = _port_simulate(wf, eet, power, mtype, "heft", window=w, chunk=5)
    assert res.stalled and int(res.agg.retired[0]) < wl.n_tasks
    assert res.n_events < 4 * wl.n_tasks
    ref = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                          power, mtype, policy="heft", lcap=3,
                          parents=wf.parents,
                          rank=wf.ranks(eet.eet.mean(1)), window=w)
    assert int((ref.status == JS.NOT_ARRIVED).sum()) > 0
    res2 = _port_simulate(wf, eet, power, mtype, "heft",
                          window=TST.min_window(wf.parents) + 5, chunk=5)
    assert not res2.stalled
    assert len(res2.resident_gids) <= TST.min_window(wf.parents) + 5


def test_resident_trace_equals_dense_trace():
    """N <= W: the stream's globalized trace rows and snapshots are the
    port's dense trace."""
    eet, power, wl, mtype = make_instance(42)
    res = _port_simulate(wl, eet, power, mtype, "mct", window=32, chunk=8,
                         trace=True, metrics=True)
    dense = TE.simulate(TW.Workload(wl.arrival, wl.type_id, wl.deadline),
                        eet.eet, power, mtype, "mct", lcap=3, trace=True,
                        metrics=True, device="cpu")
    assert res.n_events == int(dense.n_events[0])
    a, b = TT.replica_trace(res.trace, 0), TT.replica_trace(dense.trace, 0)
    for k, v in TT.events(b).items():
        _same(TT.events(a)[k], v, k)
    n = res.n_events
    for k, v in TT.snapshots(b, n).items():
        _same(TT.snapshots(a, n)[k], v, k)
    for f in JM.SimMetrics._FIELDS:
        _same(getattr(res.sim_metrics, f), getattr(dense.metrics, f), f)
    assert _np(res.agg.completed)[0] == int(
        (dense.tasks.status == JS.COMPLETED).sum())
