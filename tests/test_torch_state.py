"""The port's state, inputs and float helpers against the JAX package.

Tolerance 0 throughout: ``init_state`` field by field, the numpy input
generators, the queue reductions on a mid-run state, and the reduction
helpers that reproduce XLA's summation order, signed-zero ``min`` and
fused multiply-add.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_instance

from repro.core import eet as JEET
from repro.core import engine as E
from repro.core import state as JS
from repro.core import workload as JW
from repro_torch import interop
from repro_torch.core import eet as TEET
from repro_torch.core import state as TS
from repro_torch.core import workload as TW
from repro_torch.core.reduce import fma, ordered_sum, signed_min

pytestmark = pytest.mark.torch


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _batch(seeds=(0, 1, 2), **kw):
    reps = []
    for seed in seeds:
        eet, power, wl, mtype = make_instance(seed, **kw)
        reps.append((wl.to_task_table(), jnp.asarray(mtype, jnp.int32),
                     E.make_tables(eet, power, wl.n_tasks), jnp.int32(3)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *reps)


def test_status_codes_match():
    for name in ("NOT_ARRIVED", "IN_BATCH", "IN_MQ", "RUNNING", "COMPLETED",
                 "CANCELLED", "MISSED_QUEUE", "MISSED_RUNNING", "PREEMPTED",
                 "NUM_STATUSES"):
        assert getattr(TS, name) == getattr(JS, name), name
    assert TS.TERMINAL == JS.TERMINAL


def test_init_state_field_by_field():
    tasks, mtype, tables, pids = _batch()
    js = jax.vmap(JS.init_state)(tasks, mtype)
    reps = interop.replicas_from_numpy(tasks, mtype, tables, pids,
                                       device="cpu")
    ts = TS.init_state(reps.tasks, reps.mtype)
    for group in ("tasks", "machines"):
        for f in getattr(ts, group).__dataclass_fields__:
            a = np.asarray(getattr(getattr(js, group), f))
            b = getattr(getattr(ts, group), f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    for f in ("time", "seq_counter", "rr_ptr", "n_events", "n_preempts",
              "mq_count", "n_batch", "n_live"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_input_generators_bit_equal(seed):
    a, b = JEET.synth_eet(4, 3, inconsistency=0.3, seed=seed), \
        TEET.synth_eet(4, 3, inconsistency=0.3, seed=seed)
    np.testing.assert_array_equal(_bits(a.eet), _bits(b.eet))
    np.testing.assert_array_equal(_bits(JEET.default_power(5, seed=seed)),
                                  _bits(TEET.default_power(5, seed=seed)))
    ja = JW.poisson_workload(50, 3.0, 4, mean_eet=a.eet.mean(1), seed=seed)
    tb = TW.poisson_workload(50, 3.0, 4, mean_eet=b.eet.mean(1), seed=seed)
    for f in ("arrival", "type_id", "deadline"):
        x, y = getattr(ja, f), getattr(tb, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f)
    tt = tb.to_task_table("cpu")
    np.testing.assert_array_equal(tt.arrival[0].numpy(), ja.arrival)


def test_queue_reductions_on_a_midrun_state():
    """queue_counts, queued_work (a 100-task sum: XLA's windowed order),
    machine_available and exec_time on a random mid-run state."""
    rng = np.random.default_rng(9)
    tasks, mtype, tables, pids = _batch(n_tasks=100, n_machines=6)
    r, n = tasks.arrival.shape
    m = mtype.shape[1]
    status = rng.integers(0, 5, (r, n)).astype(np.int32)
    machine = rng.integers(0, m, (r, n)).astype(np.int32)
    running = rng.integers(-1, n, (r, m)).astype(np.int32)
    busy = rng.uniform(0, 50, (r, m)).astype(np.float32)
    time = rng.uniform(0, 50, r).astype(np.float32)
    noise = rng.lognormal(0, 0.1, (r, n)).astype(np.float32)
    tables = dataclasses.replace(tables, noise=jnp.asarray(noise))

    js = jax.vmap(JS.init_state)(tasks, mtype)
    js = dataclasses.replace(js, time=jnp.asarray(time))
    js.tasks.status, js.tasks.machine = jnp.asarray(status), \
        jnp.asarray(machine)
    js.machines.running, js.machines.busy_until = jnp.asarray(running), \
        jnp.asarray(busy)
    reps = interop.replicas_from_numpy(tasks, mtype, tables, pids,
                                       device="cpu")
    ts = TS.init_state(reps.tasks, reps.mtype)
    ts.time = torch.from_numpy(time)
    ts.tasks.status, ts.tasks.machine = torch.from_numpy(status), \
        torch.from_numpy(machine)
    ts.machines.running, ts.machines.busy_until = torch.from_numpy(running), \
        torch.from_numpy(busy)

    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda t: JS.queue_counts(t, m))(js.tasks)),
        TS.queue_counts(ts.tasks, m).numpy())
    np.testing.assert_array_equal(
        _bits(jax.jit(jax.vmap(JS.machine_available))(js, tables)),
        _bits(TS.machine_available(ts, reps.tables).numpy()))
    tid = rng.integers(0, n, (r, m)).astype(np.int32)
    want = jax.vmap(lambda tb, tk, t, mt, sp: JS.exec_time(tb, tk, t, mt, sp))(
        tables, js.tasks, jnp.asarray(tid), js.machines.mtype,
        js.machines.speed)
    got = TS.exec_time(reps.tables, ts.tasks, torch.from_numpy(tid),
                       ts.machines.mtype, ts.machines.speed)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("n", [1, 7, 32, 33, 100, 1024, 1100])
def test_ordered_sum_matches_xla(n):
    rng = np.random.default_rng(n)
    x = rng.lognormal(0, 2, (3, n, 5)).astype(np.float32)
    x[x < 0.5] = 0.0
    want = jax.jit(jax.vmap(lambda a: jnp.sum(a, axis=0)))(x)
    np.testing.assert_array_equal(
        _bits(want), _bits(ordered_sum(torch.from_numpy(x), 1).numpy()))
    want = jax.jit(lambda a: jnp.sum(a, axis=-1))(x[:, :, 0])
    np.testing.assert_array_equal(
        _bits(want), _bits(ordered_sum(torch.from_numpy(x[:, :, 0])).numpy()))


def test_signed_min_matches_xla():
    rows = [[0.0, -0.0], [-0.0, 0.0], [3.0, 0.0], [3.0, -0.0, 0.0, 1.0],
            [np.inf, np.inf], [2.0, -1.0, 5.0]]
    x = np.full((len(rows), 4), np.inf, np.float32)
    for i, row in enumerate(rows):
        x[i, :len(row)] = row
    np.testing.assert_array_equal(
        _bits(jnp.min(x, axis=1)),
        _bits(signed_min(torch.from_numpy(x), 1).numpy()))


def test_fma_matches_xla_fused_multiply_add():
    rng = np.random.default_rng(4)
    e, p, d = (rng.lognormal(0, 3, 200_000).astype(np.float32)
               for _ in range(3))
    d[::5] = 0.0
    want = jax.jit(lambda e, p, d: e + p * d)(e, p, d)
    got = fma(*(torch.from_numpy(v) for v in (p, d, e)))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
