"""The port's telemetry against the JAX package: histogram and SLO
counts, the device quantiles and the tail columns.

Tolerance 0.  On the batch of ``tests/test_torch_trace.py`` (all ten
policies on flat, dynamic-fleet and workflow instances):

* at ``drain_k=2`` the port's trace rows, snapshots and metrics counts
  equal the JAX engine's;
* the counts equal the JAX engine's under a non-default spec (a window
  width whose reciprocal rounds, an SLO target, few buckets), and the
  numpy twins ``fold_tasks_np`` of both packages on every replica;
* the tail columns ``resp/wait/slow/qdepth_p50/p95/p99`` of the port's
  ``summarize_replica`` are bitwise those of the JAX compiled sweep
  (``compile_sweep(SimParams(metrics=True))``), whose quantile
  interpolation XLA contracts into one multiply-add (``reduce.fma``);
* ``quantiles`` equals the jitted ``quantiles_jnp`` on random and edge
  counts, and ``summary``/``window_report``/``hist_quantile`` equal the
  reference's host functions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_drain_kway import (assert_bitwise, jax_run, mixed_batch,
                                   port_run)
from test_torch_trace import assert_counts_equal, assert_trace_equal, traced

from repro.core import engine as E
from repro.core import metrics as JM
from repro.launch import experiment as JX
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import metrics as TM
from repro_torch.core import state as TS
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

TAILS = tuple(f"{c}_p{q}" for c in ("resp", "wait", "slow", "qdepth")
              for q in (50, 95, 99))
ODD = TM.MetricsSpec(buckets=6, lo=0.05, hi=40.0, slo_target=5.0,
                     windows=5, window_s=3.3)


@pytest.fixture(scope="module")
def batch():
    return mixed_batch()


@pytest.fixture(scope="module")
def port_metrics(batch):
    return port_run(batch, TE.SimParams(lcap=3, metrics=True))


def test_kway2_trace_and_counts_match_jax(batch):
    jp, tp = traced(drain_k=2)
    sj, st = jax_run(batch, jp), port_run(batch, tp)
    assert_trace_equal(sj, st, range(st.n_events.shape[0]), "k=2")
    assert_counts_equal(sj, st, "k=2")
    assert_bitwise(sj, st, "k=2")


def test_counts_match_jax_under_another_spec(batch):
    """A window width of 3.3 s: the reference's compiled fold multiplies
    by its float32 reciprocal; the port must bucket every terminal time
    into the same window."""
    spec = JM.MetricsSpec(*ODD)
    sj = jax_run(batch, E.SimParams(lcap=3, metrics=True,
                                    metrics_spec=spec))
    st = port_run(batch, TE.SimParams(lcap=3, metrics=True,
                                      metrics_spec=ODD))
    assert st.metrics.spec == ODD
    assert st.metrics.win_done.shape == (st.n_events.shape[0], 5)
    assert_counts_equal(sj, st, "ODD spec")


def test_counts_match_fold_tasks_np(port_metrics):
    """Every replica's counts equal both packages' numpy twins on its
    final task table (queue depth passed through)."""
    st = port_metrics
    t = st.tasks
    for i in range(st.n_events.shape[0]):
        cols = [x[i].numpy() for x in (t.status, t.arrival, t.t_start,
                                       t.t_end)]
        got = TM.to_numpy(st.metrics, i)
        qd = got["queue_depth"]
        for want in (TM.fold_tasks_np(TM.DEFAULT_SPEC, *cols, qd),
                     JM.fold_tasks_np(JM.DEFAULT_SPEC, *cols, qd)):
            for key, col in want.items():
                assert np.array_equal(col, got[key]), (i, key)
        assert got["queue_depth"].sum() == int(st.n_events[i])
        assert got["response"].sum() == got["win_done"].sum() == int(
            (t.status[i] == TS.COMPLETED).sum())


def test_tail_columns_bitwise_jax_compiled_sweep(batch, port_metrics):
    fn = JX.compile_sweep(E.SimParams(lcap=3, metrics=True))
    want = fn(*batch[:4], batch[4], batch[5], None)
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    got = TX.summarize_replica(port_metrics, reps.tables, reps.dynamics)
    for key in TAILS + ("completed", "missed", "cancelled", "preempted",
                        "requeues"):
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.dtype == b.dtype, key
        assert a.tobytes() == b.tobytes(), (key, a, b)


def test_quantiles_bitwise_jax():
    """The device twin against the jitted reference on random counts,
    an all-zero row, one-bucket rows and the overflow bin, for the
    default and a small spec."""
    rng = np.random.default_rng(5)
    for spec_t in (TM.DEFAULT_SPEC, ODD):
        spec_j = JM.MetricsSpec(*spec_t)
        nb = spec_t.buckets + 2
        counts = rng.integers(0, 50, (12, nb)).astype(np.int32)
        counts[0] = 0
        counts[1] = 0
        counts[1, 3] = 7
        counts[2] = 0
        counts[2, -1] = 2
        counts[3, :2] = 0
        want = np.asarray(jax.jit(jax.vmap(
            lambda c: JM.quantiles_jnp(c, spec_j)))(jnp.asarray(counts)))
        got = TM.quantiles_jnp(torch.as_tensor(counts), spec_t).numpy()
        assert want.tobytes() == got.tobytes(), (spec_t, want, got)
        assert (got[0] == 0).all()


def test_host_summaries_match_jax(port_metrics):
    st = port_metrics
    for i in (0, 13, 27, 41):
        counts = TM.to_numpy(st.metrics, i)
        assert TM.summary(st.metrics, replica=i) == JM.summary(counts)
        assert TM.summary(counts) == JM.summary(counts)
        assert TM.window_report(st.metrics, replica=i) == \
            JM.window_report(counts)
        for key in TM.HIST_KEYS:
            assert TM.hist_percentiles(counts[key], TM.DEFAULT_SPEC) == \
                JM.hist_percentiles(counts[key], JM.DEFAULT_SPEC)
    assert TM.percentile([3.0, 1.0, 2.0], 50) == JM.percentile(
        [3.0, 1.0, 2.0], 50)


def test_bucket_math_matches_jax():
    for spec in (TM.DEFAULT_SPEC, ODD, TM.MetricsSpec(buckets=2, lo=1.0,
                                                      hi=100.0)):
        js = JM.MetricsSpec(*spec)
        assert TM.bucket_edges(spec).tobytes() == \
            JM.bucket_edges(js).tobytes()
        for a, b in zip(TM.bucket_bounds(spec), JM.bucket_bounds(js)):
            assert a.tobytes() == b.tobytes()
        edges = TM.bucket_edges(spec)
        x = np.concatenate([edges, np.nextafter(edges, 0), [0.0, -1.0,
                                                            1e9]])
        x = x.astype(np.float32)
        want = np.asarray(JM._bucket(js, jnp.asarray(x)))
        got = TM._bucket(spec, torch.as_tensor(x)).numpy()
        assert np.array_equal(want, got)
        assert np.array_equal(TM.bucket_np(spec, x), got)


def test_observe_fold_and_merge():
    """Closed form on two replicas: the queue-depth sample is taken only
    where the replica processed an event; the fold counts
    completions, waits and windows as the reference's closed-form
    test; ``merge`` adds counts and refuses two specs."""
    spec = TM.MetricsSpec(buckets=2, lo=1.0, hi=100.0, slo_target=5.0,
                          windows=4, window_s=16.0)
    mt = TM.init(spec, 2, "cpu")
    status = torch.tensor([[TS.COMPLETED, TS.COMPLETED, TS.MISSED_QUEUE,
                            TS.CANCELLED]] * 2, dtype=torch.int32)
    f32 = {"dtype": torch.float32}
    tasks = TS.TaskTable(
        arrival=torch.tensor([[0.0, 10.0, 0.0, 0.0]] * 2, **f32),
        type_id=torch.zeros(2, 4, dtype=torch.int32),
        deadline=torch.zeros(2, 4, **f32), status=status,
        machine=torch.zeros(2, 4, dtype=torch.int32),
        seq=torch.zeros(2, 4, dtype=torch.int32),
        t_start=torch.tensor([[1.0, 12.0, -1.0, -1.0]] * 2, **f32),
        t_end=torch.tensor([[2.0, 30.0, 40.0, 0.0]] * 2, **f32))
    waiting = TS.TaskTable(**{**tasks.__dict__, "status": torch.full(
        (2, 4), TS.IN_BATCH, dtype=torch.int32)})
    TM.observe_event(mt, waiting, torch.tensor([True, False]))
    assert mt.queue_depth.tolist() == [[0, 1, 0, 0], [0, 0, 0, 0]]
    mt = TM.fold_tasks(mt, tasks)
    assert mt.response.tolist() == [[0, 1, 1, 0]] * 2
    assert mt.wait.tolist() == [[0, 2, 0, 0]] * 2
    assert mt.win_done.tolist() == [[1, 1, 0, 0]] * 2
    assert mt.win_miss.tolist() == [[0, 0, 1, 0]] * 2
    assert mt.win_over.tolist() == [[0, 1, 0, 0]] * 2
    both = TM.merge(mt, mt)
    assert both.response.tolist() == [[0, 2, 2, 0]] * 2
    with pytest.raises(ValueError, match="cannot merge"):
        TM.merge(mt, TM.init(None, 2, "cpu"))
