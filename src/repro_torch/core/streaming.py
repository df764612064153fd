"""The bounded-memory live-task window engine, batched over replicas.

The counterpart of ``repro.core.streaming``.  The dense engine sizes
every per-task tensor by the task count N; here each replica keeps W
task slots (W fixed, N unbounded), refilled from arrival chunks, and
folds every retiring slot into running aggregates (:class:`StreamAgg`),
so memory and the cost of an event are O(W M), never O(N).

The reference scans over the chunks and, inside each chunk, loops
retire -> refill -> event (while rows are pending) under ``vmap``; after
the chunks a drain loop runs events to quiescence and a last retirement
follows.  Here one host loop walks the chunks (their count is known on
the host) and each trip is masked per replica, as ``vmap`` masks a
batched ``while_loop``:

* a chunk's trips run while any replica has ``cursor < n_valid``, events
  left and a finite time; retire and refill act on those replicas and
  the event on those with rows still pending after the refill;
* the drain's trips run while any replica has live tasks and events
  left.

The window invariants are the reference's.  Slots stay sorted by global
task id (``_compact`` after every refill), so the dense phase functions
of ``core/engine.py`` apply unchanged to the (R, W) state and every
order-sensitive rule (FCFS heads, first-index ties, admission ranks,
trace order) is the dense engine's.  Loading is eager and in stream
order, never-used slots first.  The event time is clamped, ``t =
max(next_event, time)``, because a task loaded late may carry an arrival
already past.  A slot retires when its task is terminal and, for a
workflow, every child is loaded and none still waits on it; parents are
resolved through the slot table ``pslot``.  Trace rows are written with
slot ids and rewritten to global ids right after the event, before a
refill can recycle the mapping.

Host reads: none of the window's own.  The flag that decides whether
another trip follows is computed on the device and read together with
the drain's last termination flag (``engine._drain(live=...)``), so a
trip costs what an event step of ``run_sweep`` costs; the last trip of a
chunk, in which no replica has rows pending, runs the event masked.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import energy as EN
from repro_torch.core import engine as E
from repro_torch.core import metrics as ME
from repro_torch.core import schedulers as P
from repro_torch.core import state as S
from repro_torch.core import trace as T
from repro_torch.core.eet import EETTable
from repro_torch.core.reduce import ordered_sum
from repro_torch.core.workload import Workflow, Workload

INT_MAX = S.INT_MAX


@dataclass(frozen=True)
class StreamParams:
    """Static parameters of the streaming engine: ``window`` is W, the
    live-task slot count; the rest are the reference's but ``pallas``
    (the port always runs its kernels)."""
    window: int
    lcap: int = 4
    qcap: int = 1 << 30
    cancel_infeasible: bool = True
    max_events: int | None = None
    trace: bool = False
    trace_capacity: int | None = None
    metrics: bool = False          # histograms + SLO windows in StreamAgg
    metrics_spec: ME.MetricsSpec | None = None
    drain_k: int = 1

    def sim_params(self) -> E.SimParams:
        """The dense engine's view, as the phases read it (the window
        folds the metrics itself, at retirement)."""
        return E.SimParams(lcap=self.lcap, qcap=self.qcap,
                           cancel_infeasible=self.cancel_infeasible,
                           drain_k=self.drain_k)


@dataclass
class TaskStream(S._Batched):
    """The workload as arrival-ordered chunks: every column is (R, nc, C)
    (parents (R, nc, C, K)), padded at the tail with ``gid = -1`` rows.
    ``gid`` is the global task id, nondecreasing along the stream."""
    arrival: torch.Tensor      # f32
    type_id: torch.Tensor      # i32
    deadline: torch.Tensor     # f32
    noise: torch.Tensor        # f32
    rank: torch.Tensor         # f32  HEFT upward rank
    gid: torch.Tensor          # i32  global id, -1 = padding
    parents: torch.Tensor | None = None     # i32 global parent ids, -1 pad
    n_children: torch.Tensor | None = None  # i32 out-degree of each task

    def chunk(self, i: int) -> "TaskStream":
        """Chunk ``i`` of every replica: (R, C) columns."""
        return S._map(self, lambda x: x[:, i])


@dataclass
class StreamAgg(S._Batched):
    """Running aggregates of R replicas, folded in at slot retirement:
    everything the summary needs, O(1) a replica.  (R,) tensors."""
    retired: torch.Tensor        # i32  slots retired (N when done)
    completed: torch.Tensor      # i32
    cancelled: torch.Tensor      # i32
    missed_queue: torch.Tensor   # i32
    missed_running: torch.Tensor  # i32
    preempted: torch.Tensor      # i32
    evictions: torch.Tensor      # i32  forced evictions (n_preempts)
    n_started: torch.Tensor      # i32  tasks that ever started
    sum_response: torch.Tensor   # f32  t_end - arrival over completions
    sum_wait: torch.Tensor       # f32  t_start - arrival over started
    makespan: torch.Tensor       # f32  latest terminal time (>= 0)
    metrics: object = None       # metrics.SimMetrics (metrics=True)


def _init_agg(r: int, device) -> StreamAgg:
    def z(dtype):
        return torch.zeros((r,), dtype=dtype, device=device)

    return StreamAgg(*(z(torch.int32) for _ in range(8)),
                     *(z(torch.float32) for _ in range(3)))


@dataclass
class WindowState(S._Batched):
    """The loop state of R replicas: a (R, W) ``SimState`` and the
    window's bookkeeping.  ``slot_task[r, j]`` is the global id of the
    task slot j holds (-1: never used); ``retired`` marks a slot already
    folded into ``agg`` and free for reuse."""
    sim: S.SimState
    wtab: S.StaticTables         # eet, power global; noise, rank (R, W)
    slot_task: torch.Tensor      # i32 (R, W)
    retired: torch.Tensor        # bool (R, W)
    cursor: torch.Tensor         # i32 (R,) rows of the chunk consumed
    agg: StreamAgg
    children_unloaded: torch.Tensor | None = None   # i32 (R, W)
    pslot: torch.Tensor | None = None               # i32 (R, W, K)


# --------------------------------------------------------------------------
# Window phases: retire -> refill -> compact, each masked by ``act`` (R,)
# --------------------------------------------------------------------------
def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(1, dtype=torch.int32)


def _retire(ws: WindowState, act: torch.Tensor) -> None:
    """Fold the terminal slots of the replicas ``act`` into the running
    aggregates and free them; a workflow parent stays until every child
    is loaded and no loaded child still waits on it."""
    st, tasks, a = ws.sim, ws.sim.tasks, ws.agg
    r, w = ws.slot_task.shape
    status = tasks.status
    ok = act[:, None] & S.is_terminal(status) & ~ws.retired
    if ws.pslot is not None:
        child_live = (status == S.NOT_ARRIVED) & ~ws.retired
        pv = torch.where(child_live[:, :, None] & (ws.pslot >= 0), ws.pslot,
                         w)
        refs = torch.zeros((r, w + 1), dtype=torch.int32, device=ok.device)
        refs.scatter_add_(1, pv.reshape(r, -1).long(),
                          torch.ones_like(pv.reshape(r, -1)))
        ok = ok & (ws.children_unloaded == 0) & (refs[:, :w] == 0)
    started = tasks.t_start >= 0
    done = status == S.COMPLETED
    a.retired = a.retired + _count(ok)
    a.completed = a.completed + _count(ok & done)
    a.cancelled = a.cancelled + _count(ok & (status == S.CANCELLED))
    a.missed_queue = a.missed_queue + _count(ok & (status == S.MISSED_QUEUE))
    a.missed_running = a.missed_running + _count(
        ok & (status == S.MISSED_RUNNING))
    a.preempted = a.preempted + _count(ok & (status == S.PREEMPTED))
    a.evictions = a.evictions + torch.where(ok, st.n_preempts, 0).sum(
        1, dtype=torch.int32)
    a.n_started = a.n_started + _count(ok & started)
    a.sum_response = a.sum_response + ordered_sum(torch.where(
        ok & done, tasks.t_end - tasks.arrival, 0.0), 1)
    a.sum_wait = a.sum_wait + ordered_sum(torch.where(
        ok & started, tasks.t_start - tasks.arrival, 0.0), 1)
    a.makespan = torch.maximum(a.makespan,
                               torch.where(ok, tasks.t_end, 0.0).amax(1))
    if a.metrics is not None:
        a.metrics = ME.fold_tasks(a.metrics, tasks, mask=ok)
    ws.retired = ws.retired | ok


def _refill(ws: WindowState, chunk: TaskStream, n_valid: torch.Tensor,
            act: torch.Tensor) -> None:
    """Load as many pending rows of ``chunk`` as the replica has free
    slots, in stream order, never-used slots first (a retired row is
    overwritten only once the fresh slots run out, so at N <= W the
    final table stays whole), then re-sort the window by global id."""
    st, tasks = ws.sim, ws.sim.tasks
    r, w = ws.slot_task.shape
    c = chunk.arrival.shape[1]
    free = ws.retired
    never = free & (ws.slot_task < 0)
    reuse = free & (ws.slot_task >= 0)
    load = torch.minimum(_count(free), (n_valid - ws.cursor).clamp(min=0))
    load = torch.where(act, load, 0)

    def rank(mask):
        return torch.cumsum(mask.to(torch.int32), 1, dtype=torch.int32) - 1

    fr = torch.where(never, rank(never), _count(never)[:, None] + rank(reuse))
    fr = torch.where(free, fr, w + c)
    do = free & (fr < load[:, None])
    take = (ws.cursor[:, None] + fr).clamp(0, c - 1).long()

    def ld(col, old):
        return torch.where(do, col.gather(1, take), old)

    tasks.arrival = ld(chunk.arrival, tasks.arrival)
    tasks.type_id = ld(chunk.type_id, tasks.type_id)
    tasks.deadline = ld(chunk.deadline, tasks.deadline)
    tasks.status = torch.where(do, S.NOT_ARRIVED, tasks.status)
    tasks.machine = torch.where(do, -1, tasks.machine)
    tasks.seq = torch.where(do, INT_MAX, tasks.seq)
    tasks.t_start = torch.where(do, -1.0, tasks.t_start)
    tasks.t_end = torch.where(do, -1.0, tasks.t_end)
    ws.wtab.noise = ld(chunk.noise, ws.wtab.noise)
    ws.wtab.rank = ld(chunk.rank, ws.wtab.rank)
    ws.slot_task = ld(chunk.gid, ws.slot_task)
    ws.retired = ws.retired & ~do
    st.n_preempts = torch.where(do, 0, st.n_preempts)
    st.n_live = st.n_live + _count(do)
    if ws.pslot is not None:
        k = ws.pslot.shape[2]
        cu = ld(chunk.n_children, ws.children_unloaded)
        pg = torch.where(do[:, :, None], chunk.parents.gather(
            1, take[:, :, None].expand(-1, -1, k)), -1)     # (R, W, K) gids
        # gid -> slot through the loaded table: a parent loads before its
        # last child and stays while children are unloaded, so the match
        # is total (the reference's (W, K, W) match, per replica)
        match = (ws.slot_task[:, None, None, :] == pg[:, :, :, None]) \
            & (pg >= 0)[:, :, :, None] & (~ws.retired)[:, None, None, :]
        found = match.any(3)
        new_ps = torch.where(found, match.to(torch.uint8).argmax(3),
                             -1).to(torch.int32)
        ws.pslot = torch.where(do[:, :, None], new_ps, ws.pslot)
        dec = torch.where(do[:, :, None] & found, new_ps, w).reshape(r, -1)
        sub = torch.zeros((r, w + 1), dtype=torch.int32, device=dec.device)
        sub.scatter_add_(1, dec.long(), torch.ones_like(dec))
        ws.children_unloaded = cu - sub[:, :w]
        st.deps_left = torch.where(do, (pg >= 0).sum(2, dtype=torch.int32),
                                   st.deps_left)
    ws.cursor = ws.cursor + load
    _compact(ws, act)


def _compact(ws: WindowState, act: torch.Tensor) -> None:
    """Stably sort the slots of the replicas ``act`` by global id
    (never-used slots last); ``machines.running`` and ``pslot`` hold slot
    ids, so their values go through the inverse permutation."""
    st = ws.sim
    r, w = ws.slot_task.shape
    ids = torch.arange(w, device=act.device).expand(r, w)
    key = torch.where(ws.slot_task >= 0, ws.slot_task, INT_MAX)
    perm = torch.sort(key, dim=1, stable=True).indices
    perm = torch.where(act[:, None], perm, ids)
    inv = torch.empty_like(perm).scatter_(1, perm, ids)

    def g(x):
        return x.gather(1, perm)

    def remap(x):
        """Slot ids ``x`` (R, ...) to their slots after the sort."""
        flat = x.reshape(r, -1)
        new = inv.gather(1, flat.clamp(0, w - 1).long()).to(torch.int32)
        return torch.where(flat >= 0, new, flat).view(x.shape)

    for f in dataclasses.fields(st.tasks):
        setattr(st.tasks, f.name, g(getattr(st.tasks, f.name)))
    st.machines.running = remap(st.machines.running)
    st.n_preempts = g(st.n_preempts)
    if st.deps_left is not None:
        st.deps_left = g(st.deps_left)
    ws.wtab.noise, ws.wtab.rank = g(ws.wtab.noise), g(ws.wtab.rank)
    ws.slot_task, ws.retired = g(ws.slot_task), g(ws.retired)
    if ws.pslot is not None:
        k = ws.pslot.shape[2]
        ws.children_unloaded = g(ws.children_unloaded)
        ws.pslot = remap(ws.pslot.gather(1, perm[:, :, None].expand(-1, -1,
                                                                    k)))


def _globalize_rows(tb: T.TraceBuffer, n0: torch.Tensor,
                    slot_task: torch.Tensor, act: torch.Tensor) -> None:
    """In place: rewrite slot ids to global ids in the trace rows each
    replica of ``act`` wrote since ``n0`` (before a refill can recycle
    the mapping)."""
    w = slot_task.shape[1]
    tsk = tb.ev_task
    glob = torch.where((tsk >= 0) & (tsk < w),
                       slot_task.gather(1, tsk.clamp(0, w - 1).long()), tsk)
    pos = torch.arange(tsk.shape[1], device=tsk.device)
    tb.ev_task = torch.where(act[:, None] & (pos[None, :] >= n0[:, None]),
                             glob, tsk)


@dataclass
class _Run:
    """What every event of a run reads: the policy plan, the dense
    engine's parameters, active power, the fleet's dynamics and sorted
    transitions, the event budget and the loop counters."""
    plan: P.Plan
    sparams: E.SimParams
    p_active: torch.Tensor
    dynamics: S.MachineDynamics | None
    transitions: torch.Tensor | None
    max_events: int
    stats: E.RunStats


def _pending(ws: WindowState, n_valid: torch.Tensor, max_events: int,
             ev: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's chunk-loop condition, (R,), counting the event
    ``ev`` as taken.  Time goes +inf only when every loaded task is
    terminal yet unretirable while rows are pending (a DAG whose frontier
    exceeds W): stop, and ``agg.retired < N`` flags it."""
    st = ws.sim
    n_ev = st.n_events if ev is None else st.n_events + ev.to(torch.int32)
    return (ws.cursor < n_valid) & (n_ev < max_events) \
        & torch.isfinite(st.time)


def _one_event(ws: WindowState, ev: torch.Tensor, run: _Run,
               deps: tuple | None,
               n_valid: torch.Tensor | None = None) -> bool:
    """One event timestamp of the replicas ``ev`` with the dense engine's
    six phases on the (R, W) state, the time clamped to be monotone and
    the expected-time tables rebuilt (slot contents change at refills);
    trace rows and the snapshot's running ids are globalized.  Returns
    the drain's read: whether another trip follows (inside a chunk of
    ``n_valid`` rows the chunk loop's condition, else the dense loop's
    test)."""
    st, wtab = ws.sim, ws.wtab
    w = ws.slot_task.shape[1]
    t = E._next_event_time(st, run.transitions, deps)
    st.time = torch.where(ev, torch.maximum(t, st.time), st.time)
    n0 = None if st.trace is None else st.trace.n_rows.clone()
    E._completions(st, run.p_active, ev)
    up = None
    if run.dynamics is not None:
        E._availability(st, run.dynamics, run.p_active, ev)
        up = S.machine_up(run.dynamics, st.time)
    if deps is not None:
        E._release(st, deps, ev, run.stats)
    E._arrivals(st, run.sparams.qcap, ev)
    E._deadline_drops(st, run.p_active, ev)
    const = P.expected_tables(st, wtab)
    # the drain leaves cursor, time and n_events as they are
    live = None if n_valid is None else _pending(ws, n_valid,
                                                 run.max_events, ev)
    going = E._drain(st, wtab, run.plan, run.sparams, const, ev,
                     run.max_events, run.stats, up, live)
    E._start_tasks(st, wtab, ev, up)
    if st.trace is not None:
        _globalize_rows(st.trace, n0, ws.slot_task, ev)
        running = st.machines.running
        glob = torch.where(running >= 0, ws.slot_task.gather(
            1, running.clamp(0, w - 1).long()), running)
        T.snapshot(st.trace, dataclasses.replace(
            st, machines=dataclasses.replace(st.machines, running=glob)), ev)
    if ws.agg.metrics is not None:
        # count-exact against the dense engine at N <= W: unloaded tasks
        # are NOT_ARRIVED there, unused slots terminal here
        ME.observe_event(ws.agg.metrics, st.tasks, ev)
    st.n_events = st.n_events + ev.to(torch.int32)
    run.stats.events += 1
    return going


# --------------------------------------------------------------------------
# Top-level engine
# --------------------------------------------------------------------------
def run_stream(stream: TaskStream, mtype: torch.Tensor, eet: torch.Tensor,
               power: torch.Tensor, policy_ids: torch.Tensor,
               params: StreamParams,
               dynamics: S.MachineDynamics | None = None,
               stats: E.RunStats | None = None,
               policy_params=None) -> WindowState:
    """Run R streaming replicas to completion; returns the final
    :class:`WindowState` (aggregates in ``.agg``, the fleet in
    ``.sim.machines``, the last resident tasks in the window columns).

    ``stream`` (R, nc, C) columns (:func:`make_stream`, or
    ``launch.experiment.to_streams``); ``eet`` (R, T, Mt) and ``power``
    (R, Mt, 2) are the global tables, per-task noise and rank ride in the
    stream; ``policy_ids`` (R,); every argument on the run's device.
    ``stats`` receives the loop counters; ``events`` counts trips.
    ``policy_params`` are the learned policies' weights, as in
    ``engine.run_sweep``."""
    stats = E.RunStats() if stats is None else stats
    dev = mtype.device
    w = int(params.window)
    r, n_chunks, c = stream.arrival.shape
    n_total = n_chunks * c
    m = mtype.shape[-1]
    has_deps = stream.parents is not None
    max_events = params.max_events or (4 * n_total + 16)
    if dynamics is not None and params.max_events is None:
        max_events += 2 * dynamics.down_start.shape[-1] * m
    if has_deps and params.max_events is None:
        max_events += n_total

    def full(value, dtype, shape=(r, w)):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # every slot starts retired and terminal, inert to every phase; the
    # live counter starts at zero and the refill revives slots
    tasks0 = S.TaskTable(
        arrival=full(S.INF, torch.float32), type_id=full(0, torch.int32),
        deadline=full(S.INF, torch.float32),
        status=full(S.COMPLETED, torch.int32),
        machine=full(-1, torch.int32), seq=full(INT_MAX, torch.int32),
        t_start=full(-1.0, torch.float32), t_end=full(-1.0, torch.float32))
    sim = S.init_state(tasks0, mtype, dynamics)
    sim.tasks = tasks0
    sim.n_live = torch.zeros((r,), dtype=torch.int32, device=dev)
    if has_deps:
        sim.deps_left = full(0, torch.int32)
    if params.trace:
        k = dynamics.down_start.shape[-1] if dynamics is not None else 0
        cap = params.trace_capacity or T.row_capacity_bound(
            n_total, params.lcap, m, k)
        sim.trace = T.make_buffer(r, cap, max_events, m, dev)
    wtab = S.StaticTables(eet=eet.to(torch.float32),
                          power=power.to(torch.float32),
                          noise=full(1.0, torch.float32),
                          rank=full(0.0, torch.float32))
    kk = stream.parents.shape[-1] if has_deps else 0
    ws = WindowState(
        sim=sim, wtab=wtab, slot_task=full(-1, torch.int32),
        retired=full(True, torch.bool),
        cursor=torch.zeros((r,), dtype=torch.int32, device=dev),
        agg=_init_agg(r, dev),
        children_unloaded=full(0, torch.int32) if has_deps else None,
        pslot=full(-1, torch.int32, (r, w, kk)) if has_deps else None)
    if params.metrics:
        ws.agg.metrics = ME.init(params.metrics_spec, r, dev)
    if r == 0:
        return ws
    rows = torch.arange(r, device=dev)[:, None]
    run = _Run(plan=P.Plan.make(policy_ids.to(torch.int32), sim, wtab,
                                policy_params),
               sparams=params.sim_params(),
               p_active=wtab.power[rows, sim.machines.mtype.long(), 1]
               * sim.machines.power_scale,
               dynamics=dynamics,
               transitions=None if dynamics is None
               else E.sorted_transitions(dynamics),
               max_events=max_events, stats=stats)

    def deps_of(ws):
        return None if ws.pslot is None else (ws.pslot,
                                              S.dep_index(ws.pslot))

    for i in range(n_chunks):
        chunk = stream.chunk(i)
        n_valid = _count(chunk.gid >= 0)
        ws.cursor = torch.zeros_like(ws.cursor)
        act = _pending(ws, n_valid, max_events)
        while True:
            _retire(ws, act)
            _refill(ws, chunk, n_valid, act)
            # an event only while rows are still pending (the window is
            # full): keeps the event sequence chunk-size invariant
            ev = act & (ws.cursor < n_valid)
            going = _one_event(ws, ev, run, deps_of(ws), n_valid)
            act = _pending(ws, n_valid, max_events)
            if not going:
                break
    deps = deps_of(ws)
    act = (ws.sim.n_live > 0) & (ws.sim.n_events < max_events)
    while _one_event(ws, act, run, deps):
        act = (ws.sim.n_live > 0) & (ws.sim.n_events < max_events)
    _retire(ws, torch.ones((r,), dtype=torch.bool, device=dev))
    return ws


def summarize_stream_replica(ws: WindowState, n_tasks,
                             dynamics: S.MachineDynamics | None = None
                             ) -> dict:
    """(R,) summary columns of every replica, on the device, from the
    running aggregates: the keys of ``experiment.summarize_replica``, and
    the tail columns when the run folded metrics.  ``n_tasks`` is an int
    or an (R,) tensor."""
    a, mach = ws.agg, ws.sim.machines
    span = torch.maximum(a.makespan, torch.zeros_like(a.makespan))
    active_e = ordered_sum(mach.energy, 1)
    idle_e = ordered_sum(EN.idle_energy_until(mach, ws.wtab.power, span,
                                              dynamics), 1)
    n = torch.as_tensor(n_tasks, dtype=torch.float32,
                        device=span.device).expand(span.shape)
    out = {
        "completed": a.completed,
        "missed": a.missed_queue + a.missed_running,
        "cancelled": a.cancelled,
        "preempted": a.preempted,
        "requeues": a.evictions - a.preempted,
        "availability": torch.ones_like(span) if dynamics is None
        else EN.mean_availability(EN.availability(dynamics, span)),
        "completion_rate": a.completed.to(torch.float32) / n,
        "makespan": span,
        "energy": active_e + idle_e,
        "active_energy": active_e,
        "idle_energy": idle_e,
        "mean_response": a.sum_response / torch.clamp(a.completed, min=1),
    }
    if a.metrics is not None:
        out.update(ME.tail_columns(a.metrics))
    return out


# --------------------------------------------------------------------------
# Host-side wrappers
# --------------------------------------------------------------------------
def make_stream(workload: Workload, chunk: int, *,
                noise: np.ndarray | None = None,
                rank: np.ndarray | None = None,
                parents: np.ndarray | None = None,
                device="cuda") -> TaskStream:
    """One replica's workload packed into (1, nc, C) stream columns on
    ``device``, the tail chunk padded with ``gid = -1`` rows (arrival and
    deadline inf) that the refill never loads.  ``parents`` ((N, K)
    global ids) switches on workflow mode; the out-degrees are
    precomputed so that retirement can wait for the children."""
    dev = resolve_device(device)
    n = workload.n_tasks
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n_chunks = max(-(-n // chunk), 1)
    total = n_chunks * chunk

    def put(x, shape=()):
        return torch.as_tensor(x.reshape((1, n_chunks, chunk) + shape),
                               device=dev)

    def pad(x, fill, dtype):
        out = np.full((total,), fill, dtype)
        out[:n] = x
        return put(out)

    gid = np.full((total,), -1, np.int32)
    gid[:n] = np.arange(n, dtype=np.int32)
    parents_s = n_children_s = None
    if parents is not None:
        parents = np.asarray(parents, np.int32)
        k = parents.shape[1]
        pp = np.full((total, k), -1, np.int32)
        pp[:n] = parents
        parents_s = put(pp, (k,))
        n_children = np.zeros((total,), np.int32)
        np.add.at(n_children, parents[parents >= 0], 1)
        n_children_s = put(n_children)
    return TaskStream(
        arrival=pad(workload.arrival, np.inf, np.float32),
        type_id=pad(workload.type_id, 0, np.int32),
        deadline=pad(workload.deadline, np.inf, np.float32),
        noise=pad(np.ones(n, np.float32) if noise is None else noise, 1.0,
                  np.float32),
        rank=pad(np.zeros(n, np.float32) if rank is None else rank, 0.0,
                 np.float32),
        gid=put(gid), parents=parents_s, n_children=n_children_s)


@dataclass
class StreamResult:
    """A finished one-replica :class:`WindowState` (leading axis 1) with
    what the host helpers need."""
    ws: WindowState
    n_tasks: int
    params: StreamParams
    dynamics: S.MachineDynamics | None
    eet: np.ndarray
    power: np.ndarray
    mtype: np.ndarray

    @property
    def window(self) -> int:
        return self.params.window

    @property
    def agg(self) -> StreamAgg:
        return self.ws.agg

    @property
    def machines(self) -> S.MachineState:
        return self.ws.sim.machines

    @property
    def trace(self):
        return self.ws.sim.trace

    @property
    def sim_metrics(self):
        """``metrics.SimMetrics`` of a run with ``metrics=True``, else
        None: histograms and SLO windows over every retired task."""
        return self.ws.agg.metrics

    @property
    def n_events(self) -> int:
        return int(self.ws.sim.n_events[0])

    @property
    def stalled(self) -> bool:
        """True when the run stopped with work not retired: a DAG whose
        dependency frontier exceeded the window."""
        return int(self.ws.agg.retired[0]) < self.n_tasks

    @property
    def resident_gids(self) -> np.ndarray:
        """Global ids whose rows are still held in the window."""
        slot = self.ws.slot_task[0].cpu().numpy()
        return np.sort(slot[slot >= 0])

    def resident_state(self) -> S.SimState:
        """The resident rows as a one-replica dense state in global-id
        order; at N <= W the whole final task table (retired rows keep
        their data), comparable with ``engine.simulate``'s."""
        slot = self.ws.slot_task[0].cpu().numpy()
        idx = np.nonzero(slot >= 0)[0]
        idx = idx[np.argsort(slot[idx], kind="stable")]
        sel = torch.as_tensor(idx, device=self.ws.slot_task.device)

        def g(x):
            return x[:, sel]

        st = self.ws.sim
        return dataclasses.replace(st, tasks=S._map(st.tasks, g),
                                   n_preempts=g(st.n_preempts), trace=None,
                                   metrics=None, deps_left=None)

    def summarize(self) -> dict:
        from repro_torch.core import report
        return report.summarize_stream(self)


def min_window(parents: np.ndarray) -> int:
    """Static floor on W for a DAG: a task loads only while all its
    parents are resident, so W must be at least the largest in-degree +
    1.  Necessary, not sufficient: size W generously and check
    :attr:`StreamResult.stalled` after the run."""
    p = np.asarray(parents)
    if p.size == 0:
        return 1
    return int((p >= 0).sum(axis=1).max()) + 1


def simulate_stream(workload, eet: EETTable | np.ndarray, power: np.ndarray,
                    machine_types, policy: str = "mct", *, window: int,
                    chunk: int | None = None, lcap: int = 4,
                    qcap: int | None = None, cancel_infeasible: bool = True,
                    noise: np.ndarray | None = None,
                    dynamics: S.MachineDynamics | None = None,
                    trace: bool = False, trace_capacity: int | None = None,
                    max_events: int | None = None, metrics: bool = False,
                    metrics_spec: ME.MetricsSpec | None = None,
                    policy_params=None, device="cuda") -> StreamResult:
    """One streaming replica, named policy: the ``engine.simulate``
    mirror.  ``window`` is W; ``chunk`` the stream granularity (default
    ``min(n_tasks, window)``; results do not depend on it).
    ``workload`` is a ``Workload`` or a ``Workflow`` (its dependency
    frontier must fit the window); ``dynamics`` (leading axis 1, on
    ``device``) makes the fleet dynamic; ``policy_params`` supplies the
    ``mlp``/``linear`` weights."""
    dev = resolve_device(device)
    eet_arr = np.asarray(getattr(eet, "eet", eet), np.float32)
    parents = rank = None
    if isinstance(workload, Workflow):
        parents = np.asarray(workload.parents, np.int32)
        rank = workload.ranks(eet_arr.mean(axis=1))
        workload = workload.workload
    n = workload.n_tasks
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if chunk is None:
        chunk = max(min(n, window), 1)
    stream = make_stream(workload, chunk, noise=noise, rank=rank,
                         parents=parents, device=dev)
    params = StreamParams(window=window, lcap=lcap, qcap=qcap or (1 << 30),
                          cancel_infeasible=cancel_infeasible,
                          max_events=max_events, trace=trace,
                          trace_capacity=trace_capacity, metrics=metrics,
                          metrics_spec=metrics_spec)
    mtype = np.asarray(machine_types, np.int32)
    ws = run_stream(
        stream, torch.as_tensor(mtype[None], device=dev),
        torch.as_tensor(eet_arr[None], device=dev),
        torch.as_tensor(np.asarray(power, np.float32)[None], device=dev),
        torch.tensor([P.POLICY_IDS[policy]], dtype=torch.int32, device=dev),
        params, dynamics, policy_params=policy_params)
    return StreamResult(ws=ws, n_tasks=n, params=params, dynamics=dynamics,
                        eet=eet_arr, power=np.asarray(power),
                        mtype=mtype)
