"""The port's streaming window engine against the JAX streaming engine.

Tolerance 0.  Each batch runs all ten heuristics on several instances in
one ``jax.jit(jax.vmap(run_stream))`` call, so the reference compiles
once a batch; instances of different sizes share the stream shape by
padding with ``gid = -1`` rows.  The plain batch (static fleet, no
edges) holds N <= W and N > W; the dynamic batch failure, spot and DVFS
fleets at N <= W and N > W; the mixed batch gives every row machine
dynamics and a parent table (inert where there is no failure or edge):
the dynamic batch's fleets, a chain under failures and two fork-joins.
Every ``WindowState`` field of the port's ``run_stream`` must equal the
reference's bit for bit: the slot table, the retired mask, the task
columns, ``n_preempts``, the machines, the counters, every
``StreamAgg`` field and ``n_events``.  One exception, a reference-side
fault (ROADMAP.md, queue C): in workflow mode the reference's compiler
vectorizes the W-wide sums of ``_retire`` (``sum_response``,
``sum_wait``) into a halving tree, while without a parent table it sums
in order, so one instance gives two sets of bits; the port sums in
order, bitwise the reference outside workflow mode and within a few
roundings inside it.  At N <= W the port's ``resident_state`` must be
bitwise its own dense ``run_sweep``; results must not change with the
chunk size or with any W >= N; the chunk generators must be bit-equal
to the reference's.  ``drain_k=2`` is in
``tests/test_torch_streaming_trace.py`` beside trace and metrics.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_instance

from repro.core import schedulers as P
from repro.core import streaming as ST
from repro.core import workload as JW
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import state as TS
from repro_torch.core import streaming as TST
from repro_torch.core import workload as TW

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
TASK_FIELDS = ("arrival", "type_id", "deadline", "status", "machine", "seq",
               "t_start", "t_end")
MACHINE_FIELDS = ("running", "busy_until", "active_time", "energy",
                  "speed", "power_scale")
SIM_FIELDS = ("time", "n_events", "seq_counter", "rr_ptr", "n_batch",
              "n_live", "mq_count", "n_preempts", "deps_left")
AGG_FIELDS = ("retired", "completed", "cancelled", "missed_queue",
              "missed_running", "preempted", "evictions", "n_started",
              "sum_response", "sum_wait", "makespan")
W = 16


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    bad = np.argwhere(a != b) if a.tobytes() != b.tobytes() else []
    assert len(bad) == 0, f"{what}: first differences at {bad[:4]}"


# the W-wide float sums of _retire, which the reference vectorizes in
# workflow mode (queue C)
RETIRE_SUMS = ("sum_response", "sum_wait")


def assert_window_equal(wj, wt, what="", sums_close=False):
    """Every field of a JAX and a port ``WindowState`` bitwise; with
    ``sums_close`` the retire sums within a few roundings instead."""
    for f in TASK_FIELDS:
        _same(getattr(wj.sim.tasks, f), getattr(wt.sim.tasks, f),
              f"tasks.{f} {what}")
    for f in MACHINE_FIELDS:
        _same(getattr(wj.sim.machines, f), getattr(wt.sim.machines, f),
              f"machines.{f} {what}")
    for f in SIM_FIELDS:
        a, b = getattr(wj.sim, f), getattr(wt.sim, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _same(a, b, f"{f} {what}")
    for f in ("slot_task", "retired", "cursor", "children_unloaded",
              "pslot"):
        a, b = getattr(wj, f), getattr(wt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _same(a, b, f"{f} {what}")
    _same(wj.wtab.noise, wt.wtab.noise, f"noise {what}")
    _same(wj.wtab.rank, wt.wtab.rank, f"rank {what}")
    for f in AGG_FIELDS:
        if sums_close and f in RETIRE_SUMS:
            np.testing.assert_allclose(_np(getattr(wt.agg, f)),
                                       _np(getattr(wj.agg, f)), rtol=1e-6,
                                       err_msg=f)
        else:
            _same(getattr(wj.agg, f), getattr(wt.agg, f), f"agg.{f} {what}")


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Instance:
    eet: object
    power: np.ndarray
    wl: object                 # a JAX Workload
    mtype: np.ndarray
    scen: object = None        # a JAX Scenario (None: no dynamics)
    wf: object = None          # a JAX Workflow (None: independent tasks)


def _pad_stream(s: ST.TaskStream, n_chunks: int, k: int | None):
    """A reference stream grown to ``n_chunks`` chunks (inert ``gid = -1``
    rows) and, in workflow mode, to parent width ``k``."""
    nc, c = s.arrival.shape
    extra = n_chunks - nc
    assert extra >= 0

    def grow(x, fill):
        x = np.asarray(x)
        pad = np.full((extra,) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, pad])

    out = dict(arrival=grow(s.arrival, np.inf), type_id=grow(s.type_id, 0),
               deadline=grow(s.deadline, np.inf), noise=grow(s.noise, 1.0),
               rank=grow(s.rank, 0.0), gid=grow(s.gid, -1))
    if k is not None:
        par = np.asarray(s.parents) if s.parents is not None else \
            np.full((nc, c, 1), -1, np.int32)
        wide = np.full((nc, c, k), -1, np.int32)
        wide[:, :, :par.shape[2]] = par
        out["parents"] = grow(wide, -1)
        nch = np.asarray(s.n_children) if s.n_children is not None else \
            np.zeros((nc, c), np.int32)
        out["n_children"] = grow(nch, 0)
    return {key: jnp.asarray(v) for key, v in out.items()}


def stream_batch(instances, chunk: int, *, dynamics: bool, edges: bool):
    """The ten policies on every instance, stacked: (stream, mtype, eet,
    power, policy ids, dynamics or None) as JAX arrays."""
    streams = []
    for ins in instances:
        wl = ins.wf.workload if ins.wf is not None else ins.wl
        rank = parents = None
        if ins.wf is not None:
            rank = ins.wf.ranks(ins.eet.eet.mean(1))
            parents = ins.wf.parents
        streams.append(ST.make_stream(wl, chunk, rank=rank, parents=parents))
    n_chunks = max(s.arrival.shape[0] for s in streams)
    k = max([ins.wf.parents.shape[1] for ins in instances
             if ins.wf is not None] + [1]) if edges else None
    rows = []
    for ins, s in zip(instances, streams):
        cols = _pad_stream(s, n_chunks, k)
        m = len(ins.mtype)
        dyn = None
        if dynamics:
            scen = ins.scen or JW.make_scenario(
                ins.wf.workload if ins.wf is not None else ins.wl, m,
                n_intervals=3)
            dyn = scen.dynamics()
        for p in POLICIES:
            rows.append((ST.TaskStream(**cols), jnp.asarray(ins.mtype,
                                                            jnp.int32),
                         jnp.asarray(ins.eet.eet, jnp.float32),
                         jnp.asarray(ins.power, jnp.float32),
                         jnp.int32(P.POLICY_IDS[p]), dyn))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def jax_stream(batch, params):
    fn = jax.jit(jax.vmap(lambda s, mt, e, p, pid, dyn: ST.run_stream(
        s, mt, e, p, pid, params, dyn)))
    return jax.block_until_ready(fn(*batch))


def port_params(params: ST.StreamParams) -> TST.StreamParams:
    kw = params._asdict()
    kw.pop("pallas")
    return TST.StreamParams(**kw)


def port_stream_of(s) -> TST.TaskStream:
    return TST.TaskStream(**{
        f.name: None if getattr(s, f.name) is None
        else torch.as_tensor(np.array(getattr(s, f.name)))
        for f in dataclasses.fields(TST.TaskStream)})


def port_stream(batch, params, stats=None):
    s, mt, e, p, pid, dyn = batch
    conv = lambda x: torch.as_tensor(np.array(x))       # noqa: E731
    return TST.run_stream(
        port_stream_of(s), conv(mt), conv(e), conv(p), conv(pid),
        port_params(params),
        None if dyn is None else interop.dynamics_from_numpy(dyn, "cpu"),
        stats)


def plain_instances():
    """N = 12 <= W and N = 40 > W on static fleets."""
    return [Instance(*make_instance(11, n_tasks=12)),
            Instance(*make_instance(7, n_tasks=40, rate=5.0))]


def dynamic_instances():
    """Failure, spot and DVFS fleets at N <= W and N > W."""
    out = []
    for seed, n, kw in ((11, 20, dict(fail_rate=0.25, spot=False)),
                        (12, 12, dict(fail_rate=0.3, spot=True)),
                        (13, 24, dict(fail_rate=0.3, spot=True)),
                        (14, 20, dict(fail_rate=0.0, dvfs="powersave"))):
        eet, power, wl, mtype = make_instance(seed, n_tasks=n, n_machines=3)
        scen = JW.make_scenario(wl, 3, mttr=2.0, n_intervals=3,
                                seed=seed + 2, **kw)
        out.append(Instance(eet, power, wl, mtype, scen))
    return out


def mixed_instances():
    """The dynamic instances, a chain under failures (N > W), a fork-join
    (N <= W, join in-degree 5) and a wider fork-join (N > W, in-degree
    8)."""
    out = dynamic_instances()
    eet, power, _, mtype = make_instance(17, n_tasks=16, n_machines=3)
    chain = JW.chain_workflow(30, 3, mean_eet=eet.eet.mean(1),
                              slack_jitter=0.4, seed=19)
    out.append(Instance(eet, power, None, mtype, JW.make_scenario(
        chain.workload, 3, fail_rate=0.2, mttr=2.0, n_intervals=3, seed=5),
        chain))
    for branches, length, seed in ((5, 2, 19), (8, 3, 23)):
        eet, power, _, mtype = make_instance(seed, n_tasks=16, n_machines=3)
        wf = JW.fork_join_workflow(branches, length, 3,
                                   mean_eet=eet.eet.mean(1),
                                   slack_jitter=0.4, seed=seed)
        assert ST.min_window(wf.parents) <= W
        out.append(Instance(eet, power, None, mtype, None, wf))
    return out


@pytest.fixture(scope="module")
def plain_runs():
    batch = stream_batch(plain_instances(), 8, dynamics=False, edges=False)
    params = ST.StreamParams(window=W, lcap=3)
    stats = TE.RunStats()
    return batch, jax_stream(batch, params), port_stream(batch, params,
                                                         stats), stats


@pytest.fixture(scope="module")
def dynamic_runs():
    batch = stream_batch(dynamic_instances(), 6, dynamics=True, edges=False)
    params = ST.StreamParams(window=W, lcap=3)
    return batch, jax_stream(batch, params), port_stream(batch, params)


@pytest.fixture(scope="module")
def mixed_runs():
    batch = stream_batch(mixed_instances(), 6, dynamics=True, edges=True)
    params = ST.StreamParams(window=W, lcap=3)
    return batch, jax_stream(batch, params), port_stream(batch, params)


def _rows(policy, n_rows):
    return [r for r in range(n_rows)
            if r % len(POLICIES) == POLICIES.index(policy)]


# ---------------------------------------------------------------------------
# port against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch_name", ["plain", "dynamic", "mixed"])
def test_window_state_bitwise_jax(plain_runs, dynamic_runs, mixed_runs,
                                  batch_name):
    runs = {"plain": plain_runs, "dynamic": dynamic_runs,
            "mixed": mixed_runs}[batch_name]
    _, wj, wt = runs[:3]
    assert_window_equal(wj, wt, batch_name,
                        sums_close=batch_name == "mixed")


def test_reference_vectorized_retire_sums_fault(dynamic_runs, mixed_runs):
    """Queue C fault, on the reference side: the dynamic instances give
    other ``sum_response`` and ``sum_wait`` bits when the reference runs
    them in workflow mode (the mixed batch's parent table, inert on
    these rows) than without a parent table: there its compiler sums the
    W slots as a halving tree, (x0 + x8) + ... , and here in order.  Every
    other field agrees.  The port sums in order in both modes, so its
    mixed run equals the reference's dynamic run on these rows."""
    _, jd, _ = dynamic_runs
    _, jm, wt = mixed_runs
    rows = slice(0, jd.agg.retired.shape[0])
    for f in RETIRE_SUMS:
        plain = np.asarray(getattr(jd.agg, f))
        workflow = np.asarray(getattr(jm.agg, f))[rows]
        assert (plain != workflow).any(), f
        _same(getattr(wt.agg, f).numpy()[rows], plain, f)
    for f in AGG_FIELDS:
        if f not in RETIRE_SUMS:
            _same(np.asarray(getattr(jm.agg, f))[rows],
                  np.asarray(getattr(jd.agg, f)), f)


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_retires_every_task(plain_runs, mixed_runs, policy):
    for runs, sizes in ((plain_runs, (12, 40)),
                        (mixed_runs, (20, 12, 24, 20, 30, 12, 26))):
        batch, wj, wt = runs[:3]
        n = np.repeat(np.asarray(sizes), len(POLICIES))
        rows = _rows(policy, len(n))
        _same(wj.agg.retired, wt.agg.retired, "retired")
        np.testing.assert_array_equal(wt.agg.retired.numpy()[rows], n[rows])
        assert (wt.sim.n_live.numpy()[rows] == 0).all()
        a = wt.agg
        total = a.completed + a.cancelled + a.missed_queue \
            + a.missed_running + a.preempted
        np.testing.assert_array_equal(total.numpy()[rows], n[rows])


def test_mixed_batch_exercises_the_window(mixed_runs):
    """The mixed batch evicts, preempts and cancels for failed parents,
    and its overflow rows refill slots."""
    _, _, wt = mixed_runs
    assert int(wt.agg.evictions.sum()) > int(wt.agg.preempted.sum()) > 0
    assert int(wt.agg.cancelled.sum()) > 0
    assert (wt.slot_task.numpy().max(1) >= W).any()


def test_host_reads_are_the_drains(plain_runs):
    """The window reads nothing of its own: one read a drain chunk."""
    *_, stats = plain_runs
    assert stats.host_reads == stats.drain_trips // TE.DRAIN_CHUNK
    assert stats.events > 0


# ---------------------------------------------------------------------------
# port against itself
# ---------------------------------------------------------------------------
def _one(ws, i):
    return TST.StreamResult(ws.take(slice(i, i + 1)), 0, None, None, None,
                            None, None)


@pytest.mark.parametrize("policy", POLICIES)
def test_resident_state_bitwise_dense(plain_runs, mixed_runs, policy):
    """N <= W: the resident rows are the dense ``run_sweep``'s final task
    table, and the machines its machines (static and spot fleets and a
    fork-join)."""
    cases = ((plain_runs, 0, plain_instances()[0]),
             (mixed_runs, 1, mixed_instances()[1]),
             (mixed_runs, 5, mixed_instances()[5]))
    for runs, idx, ins in cases:
        wt = runs[2]
        r = idx * len(POLICIES) + POLICIES.index(policy)
        rs = _one(wt, r).resident_state()
        wl = ins.wf.workload if ins.wf is not None else ins.wl
        tw = TW.Workflow(TW.Workload(wl.arrival, wl.type_id, wl.deadline),
                         ins.wf.parents) if ins.wf is not None else \
            TW.Workload(wl.arrival, wl.type_id, wl.deadline)
        dyn = None if ins.scen is None else interop.dynamics_from_numpy(
            jax.tree.map(lambda x: np.asarray(x)[None],
                         ins.scen.dynamics()), "cpu")
        dense = TE.simulate(tw, ins.eet.eet, ins.power, ins.mtype,
                            policy=policy, lcap=3, dynamics=dyn,
                            device="cpu")
        for f in TASK_FIELDS:
            _same(getattr(rs.tasks, f), getattr(dense.tasks, f),
                  f"{f} case {idx}")
        _same(rs.n_preempts, dense.n_preempts, "n_preempts")
        for f in MACHINE_FIELDS:
            _same(getattr(rs.machines, f), getattr(dense.machines, f), f)
        _same(rs.n_events, dense.n_events, "n_events")


def _simulate(wl, eet, power, mtype, policy, **kw):
    return TST.simulate_stream(
        TW.Workload(wl.arrival, wl.type_id, wl.deadline), eet.eet, power,
        mtype, policy, lcap=3, device="cpu", **kw)


@pytest.mark.parametrize("policy", ["mct", "minmin", "heft"])
def test_invariant_to_chunk_and_window(policy):
    """Overflow results do not change with the chunk size; at W >= N the
    final tables, the machines and the counts do not change with W (the
    float sums of the aggregates run over W slots, so their rounding
    does)."""
    eet, power, wl, mtype = make_instance(7, n_tasks=40, rate=5.0)
    base = _simulate(wl, eet, power, mtype, policy, window=6, chunk=7)
    for chunk in (1, 5, 40):
        other = _simulate(wl, eet, power, mtype, policy, window=6,
                          chunk=chunk)
        for f in AGG_FIELDS:
            _same(getattr(base.agg, f), getattr(other.agg, f), f)
        _same(base.ws.sim.n_events, other.ws.sim.n_events, "n_events")
    wide = [_simulate(wl, eet, power, mtype, policy, window=w, chunk=8)
            for w in (40, 48, 77)]
    for other in wide[1:]:
        for f in TASK_FIELDS:
            _same(getattr(wide[0].resident_state().tasks, f),
                  getattr(other.resident_state().tasks, f), f)
        for f in MACHINE_FIELDS:
            _same(getattr(wide[0].machines, f), getattr(other.machines, f),
                  f)
        for f in AGG_FIELDS:
            if f not in RETIRE_SUMS:
                _same(getattr(wide[0].agg, f), getattr(other.agg, f), f)


def test_memory_bounded_by_window():
    """N = 50 W tasks drain through (1, W) tensors."""
    w, n = 8, 400
    eet, power, wl, mtype = make_instance(5, n_tasks=n, rate=8.0)
    res = _simulate(wl, eet, power, mtype, "mct", window=w, chunk=64)
    for f in TASK_FIELDS:
        assert getattr(res.ws.sim.tasks, f).shape == (1, w), f
    assert res.ws.slot_task.shape == res.ws.wtab.noise.shape == (1, w)
    s = res.summarize()
    assert s["retired"] == n and not res.stalled
    assert s["completed"] + s["cancelled"] + s["missed"] \
        + s["preempted"] == n


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1, 5, 23, 40])
def test_chunk_generators_bit_equal(chunk):
    _, _, wl, _ = make_instance(3, n_tasks=23)
    twl = TW.Workload(wl.arrival, wl.type_id, wl.deadline)
    a = list(JW.iter_workload_chunks(wl, chunk))
    b = list(TW.iter_workload_chunks(twl, chunk))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for col in ("arrival", "type_id", "deadline"):
            _same(getattr(x, col), getattr(y, col), col)
    kw = dict(mean_eet=np.array([1.0, 2.5, 0.5], np.float32), seed=4)
    for x, y in zip(JW.poisson_workload_chunks(20, chunk, 4.0, 3, **kw),
                    TW.poisson_workload_chunks(20, chunk, 4.0, 3, **kw)):
        for col in ("arrival", "type_id", "deadline"):
            _same(getattr(x, col), getattr(y, col), col)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        next(TW.iter_workload_chunks(twl, 0))


def test_make_stream_bit_equal():
    eet, _, _, _ = make_instance(17, n_tasks=16)
    wf = JW.fork_join_workflow(5, 2, 3, mean_eet=eet.eet.mean(1), seed=3)
    rank = wf.ranks(eet.eet.mean(1))
    noise = np.linspace(0.5, 1.5, wf.n_tasks).astype(np.float32)
    a = ST.make_stream(wf.workload, 5, noise=noise, rank=rank,
                       parents=wf.parents)
    wl = wf.workload
    b = TST.make_stream(TW.Workload(wl.arrival, wl.type_id, wl.deadline), 5,
                        noise=noise, rank=rank, parents=wf.parents,
                        device="cpu")
    for f in dataclasses.fields(TST.TaskStream):
        _same(np.asarray(getattr(a, f.name))[None], getattr(b, f.name),
              f.name)
    assert TST.min_window(wf.parents) == ST.min_window(wf.parents) == 6
    assert TST.min_window(np.zeros((0, 2))) == 1


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    eet, power, wl, mtype = make_instance(3, n_tasks=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TST.simulate_stream(TW.Workload(wl.arrival, wl.type_id,
                                        wl.deadline), eet.eet, power, mtype,
                            window=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TST.make_stream(TW.Workload(wl.arrival, wl.type_id, wl.deadline), 4)
    # the learned policies, once refused, stream too: with the
    # reference's weights, the aggregates bitwise the JAX streaming run
    from repro.core import neural as JN
    pp = JN.init_params(4)
    got = _simulate(wl, eet, power, mtype, "mlp", window=4,
                    policy_params=interop.policy_params_from_numpy(
                        JN.params_to_numpy(pp), "cpu")).agg
    want = ST.simulate_stream(wl, eet, power, mtype, "mlp", window=4,
                              lcap=3, policy_params=pp).agg
    for f in dataclasses.fields(got):
        if f.name != "metrics":
            np.testing.assert_array_equal(
                getattr(got, f.name).numpy()[0],
                np.asarray(getattr(want, f.name)), err_msg=f.name)
    assert int(got.retired[0]) == 8
    assert TS.INT_MAX == TST.INT_MAX
