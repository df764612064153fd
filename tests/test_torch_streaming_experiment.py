"""The port's streaming experiment axis against ``repro.launch.experiment``.

``WorkloadAxis(streaming=W, stream_chunk=C)`` must validate as the
reference's does, ``to_streams`` must pack bit-equal stream columns, and
``run_experiment`` on a streaming spec must give the JAX compiled
streaming sweep's columns.  On replicas whose energy products are exact
(unit noise, powers-of-two power tables and DVFS multipliers), with
trace and metrics on: every column bitwise, the tail columns among them,
and the traces row by row; ``completion_rate`` is ``completed / n`` with
``n`` a traced count there, a true division (an eager ``completed / n``
and a compiled ``completed * (1 / n)`` differ, queue C).  With a dynamic
fleet of M = 4 machines the reference's compiled sweep sums the idle
energy and the availability over machines in a vectorized order (queue
C), so those columns are held within one rounding there (the port sums
in order, as the reference's report row does).  On the spec's own draws
the counts are exact and the floats close.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as JT
from repro.launch import experiment as X
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import trace as TT
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
COUNTS = ("completed", "missed", "cancelled", "preempted", "requeues")
SCENARIO = dict(fail_rates=(0.0, 0.3), dvfs_states=("powersave", "turbo"),
                spot_frac=0.5)
# summed over machines inside a fused reduction of the compiled sweep,
# in an order XLA picks when it vectorizes (queue C)
VECTORIZED = ("availability", "idle_energy", "energy")


def _specs(scenario=False, **kw):
    wk = dict(n_tasks=40, streaming=16, stream_chunk=6)
    out = []
    for lib in (X, TX):
        out.append(lib.ExperimentSpec(
            20 if not scenario else 40, lib.FleetAxis(4),
            lib.WorkloadAxis(**wk),
            scenario=lib.ScenarioAxis(**SCENARIO) if scenario else None,
            policy=lib.PolicyAxis(POLICIES), seed=3, **kw))
    return out


def _pow2(x):
    return jnp.exp2(jnp.round(jnp.log2(x)))


def _exact(reps):
    tb, dyn = reps.tables, reps.dynamics
    reps = reps._replace(tables=dataclasses.replace(
        tb, power=_pow2(tb.power), noise=jnp.ones_like(tb.noise)))
    if dyn is not None:
        reps = reps._replace(dynamics=dataclasses.replace(
            dyn, speed=_pow2(dyn.speed), power_scale=_pow2(dyn.power_scale)))
    return reps


def _port_reps(reps):
    return interop.replicas_from_numpy(reps.tasks, reps.mtype, reps.tables,
                                       reps.policy_ids, reps.dynamics,
                                       device="cpu")


def _bitwise(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.fixture(scope="module")
def flat_runs():
    jspec, tspec = _specs(trace=True, metrics=True)
    reps = _exact(X.normalize(jspec))
    stats = TE.RunStats()
    return (X.run_experiment(jspec, replicas=reps),
            TX.run_experiment(tspec, device="cpu",
                              replicas=_port_reps(reps), stats=stats), stats)


def test_flat_columns_bitwise_jax_compiled_sweep(flat_runs):
    jres, tres, _ = flat_runs
    assert set(jres.metrics) == set(tres.metrics)
    assert "resp_p99" in tres.metrics and "qdepth_p50" in tres.metrics
    for k in jres.metrics:
        _bitwise(jres.metrics[k], tres.metrics[k], k)
    assert jres.by_policy() == tres.by_policy()
    assert tres.state is None and tres.window is not None
    assert tres.window.sim.tasks.status.shape == (20, 16)


def test_flat_traces_bitwise_jax(flat_runs):
    jres, tres, stats = flat_runs
    jt, pt = jres.traces, tres.traces
    assert jt.cap == pt.cap
    for i in range(20):
        je = JT.events(jax.tree.map(lambda x: np.asarray(x)[i], jt))
        pe = TT.events(TT.replica_trace(pt, i))
        for key in ("time", "kind", "task", "machine"):
            _bitwise(je[key], torch.as_tensor(pe[key]), f"{key} r={i}")
    for f in ("snap_time", "snap_batch", "snap_mq", "snap_running",
              "snap_energy"):
        _bitwise(getattr(jt, f), getattr(pt, f), f)
    assert stats.host_reads == stats.drain_trips // TE.DRAIN_CHUNK


@pytest.fixture(scope="module")
def scenario_runs():
    jspec, tspec = _specs(scenario=True)
    reps = _exact(X.normalize(jspec))
    return X.run_experiment(jspec, replicas=reps), TX.run_experiment(
        tspec, device="cpu", replicas=_port_reps(reps))


def test_scenario_columns_bitwise(scenario_runs):
    """Every column bitwise against the compiled sweep's but for the
    three sums over machines that it vectorizes, which stay within one
    rounding (the report row, summed in order, is held bitwise in
    ``tests/test_torch_streaming_trace.py``)."""
    jres, tres = scenario_runs
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        if k in VECTORIZED:
            np.testing.assert_allclose(b, a, rtol=2**-22, err_msg=k)
        else:
            _bitwise(a, tres.metrics[k], k)
    assert tres.metrics["preempted"].sum() > 0
    assert tres.metrics["requeues"].sum() > 0
    assert (tres.metrics["availability"] < 1).any()


def test_natural_draws_counts_exact_floats_close():
    jspec, tspec = _specs(scenario=True)
    jres = X.run_experiment(jspec)
    tres = TX.run_experiment(tspec, device="cpu")
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        assert a.dtype == b.dtype, k
        if k in COUNTS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("chunk", [1, 6, 40, 41])
def test_to_streams_bit_equal(chunk):
    jspec, tspec = _specs()
    reps = X.normalize(jspec)
    a = X.to_streams(reps, chunk)
    b = TX.to_streams(TX.normalize(tspec, device="cpu"), chunk)
    for f in ("arrival", "type_id", "deadline", "noise", "rank", "gid"):
        _bitwise(getattr(a, f), getattr(b, f), f)
    assert b.parents is None and b.n_children is None


def test_stream_params_and_chunk_follow_the_reference():
    jspec, tspec = _specs(trace=True, metrics=True)
    jp, tp = jspec.stream_params, tspec.stream_params
    for f in ("window", "lcap", "qcap", "cancel_infeasible", "max_events",
              "trace", "trace_capacity", "metrics", "metrics_spec"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert jspec.stream_chunk == tspec.stream_chunk == 6
    assert tspec.streaming and not TX.ExperimentSpec(
        2, TX.FleetAxis(2), TX.WorkloadAxis(4)).streaming
    assert TX.ExperimentSpec(2, TX.FleetAxis(2), TX.WorkloadAxis(
        40, streaming=8)).stream_chunk == 8


@pytest.mark.parametrize("kw, match", [
    (dict(streaming=8, shapes=("chain",)), "does not compose with shapes"),
    (dict(stream_chunk=4), "stream_chunk requires streaming"),
    (dict(streaming=0), "streaming window must be >= 1"),
    (dict(streaming=4, stream_chunk=0), "stream_chunk must be >= 1"),
])
def test_workload_axis_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        X.WorkloadAxis(16, **kw)
    with pytest.raises(ValueError, match=match):
        TX.WorkloadAxis(16, **kw)


def test_to_streams_refuses_parent_tables():
    spec = TX.ExperimentSpec(2, TX.FleetAxis(2),
                             TX.WorkloadAxis(8, shapes=("chain",)),
                             policy=TX.PolicyAxis(("mct", "heft")))
    with pytest.raises(ValueError, match="parent tables"):
        TX.to_streams(TX.normalize(spec, device="cpu"), 4)
