"""The E2C discrete-event engine in PyTorch, batched over replicas.

The counterpart of ``repro.core.engine`` for independent tasks and
workflows (DAGs) on a static or dynamic fleet.  The reference runs one
``lax.while_loop`` per replica under ``vmap``; here one Python loop
advances all R replicas together.  Each trip of the loop processes one
event timestamp of every replica that is still running (its own
timestamp), and every phase masks its updates with that replica's
``active`` flag, which is what ``vmap`` does to a batched
``while_loop``.  Event order within a timestamp
matches the reference:

  1. completions  (``busy_until <= t``),
  2. availability (dynamic fleets only: a machine inside a down interval
     preempts its running task and flushes its queue, killing or
     requeueing the evicted tasks; partial energy is charged),
  2b. release     (workflows only: recount each task's parents that are
     not terminal; a task whose parents all ended, some without
     completing, is cancelled, and the cancels cascade to a fixpoint),
  3. arrivals     (``arrival <= t``, and for a workflow every parent
     completed -> batch queue, overflow -> cancelled),
  4. deadline drops (queued -> MISSED_QUEUE, running -> MISSED_RUNNING),
  5. scheduler drain (policy decisions until a no-op or the batch queue
     is exhausted; down machines have no room; the cancellation wrapper
     may cancel instead),
  6. start tasks on idle machines that are up (lowest mapping sequence
     first).

An (R, N, K) parent table adds the release phase, gates arrivals on
``deps_left == 0`` and makes a pending cascade an event at the current
time.  A ``MachineDynamics`` adds the availability phase, the
machines' DVFS multipliers (``speed`` divides the expected and actual
execution times, ``power_scale`` multiplies power) and the
down-interval transitions as event candidates; without one the
static-fleet path runs unchanged.

Floats are computed with the reference's expressions in the reference's
order (``time + dur``, ``avail + eet``); the energy charges ``energy +
p_active * dur``, which XLA fuses into one multiply-add, go through
``reduce.fma``, and the one float sum of the loop, the queued work in
each machine queue, through ``reduce.ordered_sum``, so final states are
bitwise those of the JAX engine on the CPU (ROADMAP.md, queue C, names
the inputs where the reference's own fusion makes that impossible).
The machine picks, the Min-Min pair search, the start picks and the
next-event minima always go through the wrappers of
``kernels/sched_argmin.py``: the CUDA kernels on the card, their plain
versions on the CPU (the reference with ``pallas=True``).

``SimParams(drain_k=K)`` makes each drain trip decide up to K sequential
decisions at once (``schedulers.dispatch_k``) and apply the valid prefix
in one masked scatter, bitwise the one-at-a-time drain;
``legacy_drain`` recomputes the machine-available vector every trip, as
the reference's baseline loop does.

``SimParams(trace=True)`` records every lifecycle transition and a
fleet snapshot per event into ``SimState.trace`` (``core/trace.py``),
and ``metrics=True`` a queue-depth sample per event plus the per-task
histograms and SLO windows after the loop into ``SimState.metrics``
(``core/metrics.py``), in the reference's order and with its masks; both
read the state only, on the device, so the final state, the loop
counters and the host reads are those of a run without them.

Host reads: the drain runs in chunks of ``DRAIN_CHUNK`` trips and reads
one pair of flags after each chunk (is any replica still draining, is
any replica still live); the last read of an event also decides whether
another event follows, so the event loop adds no read of its own and a
run costs one read per event step plus one per extra chunk.  A
workflow's release phase reads one flag after each chunk of cascade
passes, the chunks doubling from one pass (most events cascade nothing).
State tensors that the run creates are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import metrics as ME
from repro_torch.core import schedulers as P
from repro_torch.core import state as S
from repro_torch.core import trace as T
from repro_torch.core.eet import EETTable
from repro_torch.core.workload import Workflow
from repro_torch.core.reduce import fma, ordered_sum, signed_min
from repro_torch.kernels import sched_argmin as K

DRAIN_CHUNK = 2     # drain trips between host reads


@dataclass(frozen=True)
class SimParams:
    """Static simulation parameters, the reference's but ``pallas``
    (the port always runs its kernels)."""
    lcap: int = 4                  # machine-queue size
    qcap: int = 1 << 30            # batch-queue capacity
    cancel_infeasible: bool = True
    max_events: int | None = None
    trace: bool = False            # record a trace.TraceBuffer
    trace_capacity: int | None = None   # rows; default row_capacity_bound
    metrics: bool = False          # histograms + SLO windows
    metrics_spec: ME.MetricsSpec | None = None   # None = DEFAULT_SPEC
    drain_k: int = 1               # decisions a drain trip makes at once
    legacy_drain: bool = False     # recompute avail every drain trip


@dataclass
class RunStats:
    """Loop counters of one ``run_sweep`` call, filled in by the run."""
    events: int = 0         # event steps (loop trips over all replicas)
    drain_trips: int = 0    # drain trips, including masked no-op trips
    release_trips: int = 0  # cascade passes, including masked no-op ones
    host_reads: int = 0     # device-to-host flag reads


# --------------------------------------------------------------------------
# Masked updates
# --------------------------------------------------------------------------
def _put(x: torch.Tensor, idx: torch.Tensor, val, on: torch.Tensor) -> None:
    """In place: ``x[r, idx[r]] = val[r]`` where ``on[r]`` (one index per
    replica; the reference's scatter with ``mode="drop"``)."""
    i = torch.where(on, idx, 0).long()[:, None]
    cur = x.gather(1, i)
    if not isinstance(val, torch.Tensor):
        val = torch.full_like(cur, val)
    x.scatter_(1, i, torch.where(on[:, None], val.reshape(cur.shape).to(
        x.dtype), cur))


def _put_many(x: torch.Tensor, idx: torch.Tensor, val,
              on: torch.Tensor) -> torch.Tensor:
    """``x[r, idx[r, k]] = val[r, k]`` where ``on[r, k]``; the indices a
    row writes must be distinct (each machine runs its own task).  Off
    entries write to a spare column that is cut away."""
    n = x.shape[1]
    ext = torch.cat([x, x[:, :1]], 1)
    i = torch.where(on, idx, n).long()
    if not isinstance(val, torch.Tensor):
        val = torch.full(i.shape, val, dtype=x.dtype, device=x.device)
    ext.scatter_(1, i, val.to(x.dtype))
    return ext[:, :n].contiguous()


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(1, dtype=torch.int32)


def _ids(x: torch.Tensor) -> torch.Tensor:
    """(W,) the column ids of an (R, W) tensor."""
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


# --------------------------------------------------------------------------
# Event phases (each masked by the (R,) ``act`` flag)
# --------------------------------------------------------------------------
def _completions(st: S.SimState, p_active: torch.Tensor,
                 act: torch.Tensor) -> None:
    mach, tasks = st.machines, st.tasks
    n = tasks.arrival.shape[1]
    done_m = act[:, None] & (mach.running >= 0) & (
        mach.busy_until <= st.time[:, None])
    rid = mach.running.clamp(0, n - 1).long()
    dur = torch.where(done_m, mach.busy_until - tasks.t_start.gather(1, rid),
                      0.0)
    if st.trace is not None:
        T.record(st.trace, st.time, T.EV_COMPLETE, mach.running,
                 _ids(mach.running), done_m)
    tasks.status = _put_many(tasks.status, mach.running, S.COMPLETED, done_m)
    tasks.t_end = _put_many(tasks.t_end, mach.running,
                            torch.where(done_m, mach.busy_until, 0.0), done_m)
    mach.energy = fma(p_active, dur, mach.energy)
    mach.active_time = mach.active_time + dur
    mach.running = torch.where(done_m, -1, mach.running)
    st.n_live = st.n_live - _count(done_m)


def _availability(st: S.SimState, dyn: S.MachineDynamics,
                  p_active: torch.Tensor, act: torch.Tensor) -> None:
    """Evict the work of machines that are down at the replica's time:
    the running task is charged its partial slice and, per ``dyn.kill``,
    ends PREEMPTED or rejoins the batch queue to restart from scratch;
    the machine queue is flushed the same way."""
    tasks, mach = st.tasks, st.machines
    n = tasks.arrival.shape[1]
    n_m = mach.mtype.shape[1]
    t = st.time[:, None]
    down = act[:, None] & ~S.machine_up(dyn, st.time)          # (R, M)

    # running tasks on down machines: charge the partial slice
    running0 = mach.running
    hit = down & (running0 >= 0)
    rid = running0.clamp(0, n - 1).long()
    dur = torch.where(hit, t - tasks.t_start.gather(1, rid), 0.0)
    mach.energy = fma(p_active, dur, mach.energy)
    mach.active_time = mach.active_time + dur
    mach.running = torch.where(hit, -1, running0)
    kill_hit = hit & dyn.kill
    req_hit = hit & ~dyn.kill
    if st.trace is not None:
        T.record(st.trace, st.time,
                 torch.where(dyn.kill, T.EV_PREEMPT, T.EV_REQUEUE),
                 running0, _ids(running0), hit)
    status = _put_many(tasks.status, running0,
                       torch.where(dyn.kill, S.PREEMPTED, S.IN_BATCH), hit)
    t_end = _put_many(tasks.t_end, running0, t.expand_as(running0),
                      kill_hit)
    tasks.t_start = _put_many(tasks.t_start, running0, -1.0, req_hit)
    machine = _put_many(tasks.machine, running0, -1, req_hit)
    seq = _put_many(tasks.seq, running0, S.INT_MAX, req_hit)
    n_pre = _put_many(st.n_preempts, running0,
                      st.n_preempts.gather(1, rid) + 1, hit)

    # queued tasks on down machines: flush the machine queue
    m_of = machine.clamp(0, n_m - 1).long()
    in_down_q = (status == S.IN_MQ) & (machine >= 0) & down.gather(1, m_of)
    kill_of = dyn.kill.gather(1, m_of)
    kq = in_down_q & kill_of
    rq = in_down_q & ~kill_of
    if st.trace is not None:
        T.record(st.trace, st.time,
                 torch.where(kill_of, T.EV_PREEMPT, T.EV_REQUEUE),
                 _ids(machine), machine, in_down_q)
    tasks.status = torch.where(kq, S.PREEMPTED,
                               torch.where(rq, S.IN_BATCH, status))
    tasks.t_end = torch.where(kq, t, t_end)
    tasks.machine = torch.where(rq, -1, machine)
    tasks.seq = torch.where(rq, S.INT_MAX, seq)
    st.n_preempts = n_pre + in_down_q.to(torch.int32)
    st.mq_count = torch.where(down, 0, st.mq_count)
    st.n_live = st.n_live - _count(kill_hit) - _count(kq)
    st.n_batch = st.n_batch + _count(req_hit) + _count(rq)


def _release(st: S.SimState, deps: tuple, act: torch.Tensor,
             stats: RunStats) -> None:
    """Recount ``deps_left`` from the status column and cancel the tasks
    whose parents all terminated, some without completing, until a pass
    cancels nothing.  A pass that cancels nothing recomputes the same
    counts, so the passes run in masked chunks, one host read a chunk;
    a chunk is twice the last, from one pass.  The cascade's cancels are
    traced once after the fixpoint, in task-id order."""
    parents, index = deps
    tasks = st.tasks
    on = act.clone()
    before = tasks.status.clone() if st.trace is not None else None
    chunk = 1
    while True:
        for _ in range(chunk):
            left, failed = S.dep_state(tasks.status, parents, index)
            kill = on[:, None] & (tasks.status == S.NOT_ARRIVED) & (
                left == 0) & failed
            tasks.status = torch.where(kill, S.CANCELLED, tasks.status)
            tasks.t_end = torch.where(kill, st.time[:, None], tasks.t_end)
            st.deps_left = torch.where(on[:, None], left, st.deps_left)
            st.n_live = st.n_live - _count(kill)
            on = on & kill.any(1)
            stats.release_trips += 1
        stats.host_reads += 1
        if not bool(on.any()):
            break
        chunk *= 2
    if before is not None:
        T.record(st.trace, st.time, T.EV_CANCEL, _ids(before), -1,
                 (before == S.NOT_ARRIVED) & (tasks.status == S.CANCELLED))


def _arrivals(st: S.SimState, qcap: int, act: torch.Tensor) -> None:
    tasks = st.tasks
    new = act[:, None] & (tasks.status == S.NOT_ARRIVED) & (
        tasks.arrival <= st.time[:, None])
    if st.deps_left is not None:
        new = new & (st.deps_left == 0)
    pos = torch.cumsum(new.to(torch.int32), 1, dtype=torch.int32)
    admitted = new & (st.n_batch[:, None] + pos <= qcap)
    overflow = new & ~admitted
    if st.trace is not None:
        T.record(st.trace, st.time, T.EV_CANCEL, _ids(overflow), -1,
                 overflow)
    status = torch.where(admitted, S.IN_BATCH, tasks.status)
    tasks.status = torch.where(overflow, S.CANCELLED, status)
    tasks.t_end = torch.where(overflow, tasks.arrival, tasks.t_end)
    st.n_batch = st.n_batch + _count(admitted)
    st.n_live = st.n_live - _count(overflow)


def _deadline_drops(st: S.SimState, p_active: torch.Tensor,
                    act: torch.Tensor) -> None:
    tasks, mach = st.tasks, st.machines
    n = tasks.arrival.shape[1]
    n_m = mach.mtype.shape[1]
    # queued tasks (batch queue or machine queue) past their deadline
    waiting = (tasks.status == S.IN_BATCH) | (tasks.status == S.IN_MQ)
    miss_q = act[:, None] & waiting & (tasks.deadline <= st.time[:, None])
    from_mq = miss_q & (tasks.status == S.IN_MQ)
    left = torch.zeros((st.mq_count.shape[0], n_m + 1), dtype=torch.int32,
                       device=from_mq.device)
    left.scatter_add_(1, torch.where(from_mq, tasks.machine, n_m).long(),
                      torch.ones_like(tasks.machine))
    st.mq_count = st.mq_count - left[:, :n_m]
    st.n_batch = st.n_batch - _count(miss_q & (tasks.status == S.IN_BATCH))
    if st.trace is not None:
        T.record(st.trace, st.time, T.EV_MISS_QUEUE, _ids(miss_q),
                 tasks.machine, miss_q)
    status = torch.where(miss_q, S.MISSED_QUEUE, tasks.status)
    t_end = torch.where(miss_q, tasks.deadline, tasks.t_end)

    # running tasks past their deadline: drop, charge partial energy
    run_id = mach.running.clamp(0, n - 1).long()
    run_dl = tasks.deadline.gather(1, run_id)
    miss_r = act[:, None] & (mach.running >= 0) & (
        run_dl <= st.time[:, None])
    if st.trace is not None:
        T.record(st.trace, st.time, T.EV_MISS_RUNNING, mach.running,
                 _ids(mach.running), miss_r)
    dur = torch.where(miss_r, run_dl - tasks.t_start.gather(1, run_id), 0.0)
    tasks.status = _put_many(status, mach.running, S.MISSED_RUNNING, miss_r)
    tasks.t_end = _put_many(t_end, mach.running,
                            torch.where(miss_r, run_dl, 0.0), miss_r)
    mach.energy = fma(p_active, dur, mach.energy)
    mach.active_time = mach.active_time + dur
    mach.running = torch.where(miss_r, -1, mach.running)
    st.n_live = st.n_live - _count(miss_q) - _count(miss_r)


def _apply_decision(st: S.SimState, dec: P.Decision, on: torch.Tensor
                    ) -> torch.Tensor:
    """Apply each replica's decision where ``on``; returns the (R,)
    mask of replicas that mapped a task."""
    tasks = st.tasks
    n_m = st.machines.mtype.shape[1]
    acted = on & (dec.task >= 0)
    do_map = acted & ~dec.cancel
    do_cancel = acted & dec.cancel
    _put(tasks.status, dec.task,
         torch.where(dec.cancel, S.CANCELLED, S.IN_MQ), acted)
    _put(tasks.machine, dec.task, dec.machine, do_map)
    _put(tasks.seq, dec.task, st.seq_counter, do_map)
    _put(tasks.t_end, dec.task, st.time, do_cancel)
    st.rr_ptr = torch.where(do_map, (dec.machine + 1) % n_m, st.rr_ptr)
    ids = torch.arange(n_m, device=dec.machine.device)
    st.mq_count = st.mq_count + (
        (ids == dec.machine[:, None]) & do_map[:, None]).to(torch.int32)
    st.seq_counter = st.seq_counter + do_map.to(torch.int32)
    st.n_batch = st.n_batch - acted.to(torch.int32)
    st.n_live = st.n_live - do_cancel.to(torch.int32)
    return do_map


def _apply_decisions_k(st: S.SimState, dec: P.Decision, use: torch.Tensor
                       ) -> torch.Tensor:
    """Apply each replica's (R, k) prefix ``use`` of K-way decisions in
    one masked scatter: per candidate what ``_apply_decision`` does, the
    mapping sequence numbers in candidate order and ``rr_ptr`` one past
    the last mapped machine.  The prefix's tasks are distinct.  Returns
    the (R,) applied counts."""
    tasks = st.tasks
    n_m = st.machines.mtype.shape[1]
    k = dec.task.shape[1]
    do_map = use & ~dec.cancel
    do_cxl = use & dec.cancel
    maps = do_map.to(torch.int32)
    seq_rank = torch.cumsum(maps, 1, dtype=torch.int32) - maps
    tasks.status = _put_many(tasks.status, dec.task, torch.where(
        dec.cancel, S.CANCELLED, S.IN_MQ), use)
    tasks.machine = _put_many(tasks.machine, dec.task, dec.machine, do_map)
    tasks.seq = _put_many(tasks.seq, dec.task,
                          st.seq_counter[:, None] + seq_rank, do_map)
    tasks.t_end = _put_many(tasks.t_end, dec.task,
                            st.time[:, None].expand(-1, k), do_cxl)
    added = torch.zeros((do_map.shape[0], n_m + 1), dtype=torch.int32,
                        device=do_map.device)
    added.scatter_add_(1, torch.where(do_map, dec.machine, n_m).long(),
                       torch.ones_like(maps))
    st.mq_count = st.mq_count + added[:, :n_m]
    steps = torch.arange(k, device=do_map.device)
    last = torch.where(do_map, steps, -1).amax(1)
    m_last = dec.machine.gather(1, last.clamp(min=0)[:, None])[:, 0]
    st.rr_ptr = torch.where(last >= 0, (m_last + 1) % n_m, st.rr_ptr)
    n_applied = _count(use)
    st.seq_counter = st.seq_counter + _count(do_map)
    st.n_batch = st.n_batch - n_applied
    st.n_live = st.n_live - _count(do_cxl)
    return n_applied


def _drain(st: S.SimState, tb: S.StaticTables, plan: P.Plan,
           params: SimParams, const: tuple, act: torch.Tensor,
           max_events: int, stats: RunStats,
           up: torch.Tensor | None = None,
           live: torch.Tensor | None = None) -> bool:
    """Invoke every replica's scheduler until it returns a no-op or its
    batch queue (as counted at the start of the drain) is exhausted.

    The machine-available vector is computed once per event and carried
    through the trips with one exact add per mapped decision, as in the
    reference.  Returns whether any replica is still live after this
    event (read together with the drain's last termination flag);
    ``live``, an (R,) flag the caller computed, replaces that test where
    its loop has another condition (the streaming window's).  The drain's
    cancels are traced after the loop, in task-id order, by a status
    diff."""
    eet_nm = const[0]
    before = st.tasks.status.clone() if st.trace is not None else None
    mach = st.machines
    n_m = mach.mtype.shape[1]
    bound = st.n_batch.clone()
    k = max(1, int(params.drain_k))
    if params.legacy_drain:
        # the reference's baseline loop: avail recomputed every trip
        # (``avail=None``), the bound counted from the statuses
        bound = _count(st.tasks.status == S.IN_BATCH)
    draining = act & (bound > 0)
    t = st.time[:, None]
    base = torch.maximum(t, torch.where(mach.running >= 0, mach.busy_until,
                                        t))
    in_mq = S.queued_mask(st.tasks, n_m)
    avail = base + ordered_sum(torch.where(in_mq, eet_nm, 0.0), 1)
    del in_mq
    ids = torch.arange(n_m, device=avail.device)
    rows = torch.arange(avail.shape[0], device=avail.device)
    iters = torch.zeros_like(bound)
    while True:
        for _ in range(DRAIN_CHUNK):
            if k > 1 and not params.legacy_drain:
                dec, use, av = P.dispatch_k(
                    plan, st, tb, params.lcap, params.cancel_infeasible, k,
                    const, avail=avail, up=up)
                iters = iters + _apply_decisions_k(
                    st, dec, use & draining[:, None])
                avail = torch.where(draining[:, None], av, avail)
                first = dec.task[:, 0]
            else:
                dec = P.dispatch(plan, st, tb, params.lcap,
                                 params.cancel_infeasible, const,
                                 avail=None if params.legacy_drain
                                 else avail, up=up)
                do_map = _apply_decision(st, dec, draining)
                m_oh = (ids == dec.machine[:, None]) & do_map[:, None]
                avail = torch.where(
                    m_oh, avail + eet_nm[rows, dec.task.clamp(min=0).long()],
                    avail)
                iters = iters + draining.to(torch.int32)
                first = dec.task
            draining = draining & (first >= 0) & (iters < bound)
            stats.drain_trips += 1
        alive = (st.n_live > 0) & (st.n_events + 1 < max_events) \
            if live is None else live
        still, more = torch.stack([draining.any(), alive.any()]).tolist()
        stats.host_reads += 1
        if not still:
            if before is not None:
                T.record(st.trace, st.time, T.EV_CANCEL, _ids(before), -1,
                         (before != S.CANCELLED)
                         & (st.tasks.status == S.CANCELLED))
            return bool(more)


def _start_tasks(st: S.SimState, tb: S.StaticTables, act: torch.Tensor,
                 up: torch.Tensor | None = None) -> None:
    tasks, mach = st.tasks, st.machines
    n = tasks.arrival.shape[1]
    n_m = mach.mtype.shape[1]
    # lowest mapping-seq task queued on each machine
    pick, has = K.fused_start_pick(tasks.status, tasks.machine, tasks.seq,
                                   n_m, in_mq=S.IN_MQ)
    start = act[:, None] & (mach.running < 0) & has
    if up is not None:
        start = start & up
    if st.trace is not None:
        T.record(st.trace, st.time, T.EV_START, pick, _ids(pick), start)
    dur = S.exec_time(tb, tasks, pick.clamp(0, n - 1).long(), mach.mtype,
                      mach.speed)
    t = st.time[:, None]
    tasks.status = _put_many(tasks.status, pick, S.RUNNING, start)
    tasks.t_start = _put_many(tasks.t_start, pick, t.expand_as(pick), start)
    mach.running = torch.where(start, pick, mach.running)
    mach.busy_until = torch.where(start, t + dur, mach.busy_until)
    st.mq_count = st.mq_count - start.to(torch.int32)


def sorted_transitions(dyn: S.MachineDynamics) -> torch.Tensor:
    """(R, 2MK + 1) run-invariant availability transitions of each
    replica, sorted and +inf-terminated: the earliest one after the
    current time is then one ``searchsorted``."""
    r = dyn.down_start.shape[0]
    trans = torch.cat([dyn.down_start.reshape(r, -1),
                       dyn.down_end.reshape(r, -1)], 1)
    inf = torch.full((r, 1), S.INF, dtype=trans.dtype, device=trans.device)
    return torch.cat([torch.sort(trans, 1).values, inf], 1)


def _fold_transitions(t: torch.Tensor, st: S.SimState,
                      transitions: torch.Tensor | None) -> torch.Tensor:
    """Availability transitions strictly after the current time are
    event candidates too."""
    if transitions is None:
        return t
    idx = torch.searchsorted(transitions, st.time[:, None].contiguous(),
                             right=True)
    idx = idx.clamp(max=transitions.shape[1] - 1)
    return torch.minimum(t, transitions.gather(1, idx)[:, 0])


def _next_event_time(st: S.SimState,
                     transitions: torch.Tensor | None = None,
                     deps: tuple | None = None) -> torch.Tensor:
    tasks, mach = st.tasks, st.machines
    status = tasks.status
    pending = None
    if deps is not None:
        # a task that waits on a parent has no arrival event of its own
        # (the parent's terminal transition is one): the kernel sees it
        # as not NOT_ARRIVED, which leaves the minimum over the others
        # bitwise.  A cascade left pending by phases 3-6 fires at the
        # current time.
        left, failed = S.dep_state(status, *deps)
        waiting = status == S.NOT_ARRIVED
        pending = (waiting & (left == 0) & failed).any(1)
        status = torch.where(waiting & ((left > 0) | failed), -1, status)
    t_arr, t_dl = K.fused_event_bounds(
        status, tasks.arrival, tasks.deadline,
        not_arrived=S.NOT_ARRIVED, live_lo=S.IN_BATCH, live_hi=S.RUNNING)
    if pending is not None:
        t_arr = torch.minimum(t_arr, torch.where(pending, st.time, S.INF))
    t_cmp = signed_min(torch.where(mach.running >= 0, mach.busy_until,
                                   S.INF), 1)
    return _fold_transitions(torch.minimum(torch.minimum(t_arr, t_cmp),
                                           t_dl), st, transitions)


# --------------------------------------------------------------------------
# Top-level engine
# --------------------------------------------------------------------------
def run_sweep(tasks: S.TaskTable, mtype: torch.Tensor,
              tables: S.StaticTables, policy_ids: torch.Tensor,
              params: SimParams = SimParams(),
              stats: RunStats | None = None,
              dynamics: S.MachineDynamics | None = None,
              parents: torch.Tensor | None = None,
              policy_params=None) -> S.SimState:
    """Run R replicas to completion; returns the final (R, ...) state.

    Every argument carries the leading replica axis and lies on the
    device the run uses.  ``policy_ids`` (R,) picks each replica's
    policy by the reference's ids (``schedulers.POLICY_IDS``).  Pass a
    ``RunStats`` to read the loop's event, trip and host-read counts,
    a ``MachineDynamics`` to make the fleet dynamic (failures, spot
    preemption, DVFS), and an (R, N, K) i32 ``parents`` table, padded
    with -1, to run workflows (a task arrives once every parent
    completed).  ``policy_params`` (``neural.PolicyParams``) are the
    learned policies' weights, shared by every replica or stacked along
    a leading R axis (an ES population in one call); None =
    ``neural.default_params()``, as in the reference."""
    stats = RunStats() if stats is None else stats
    st = S.init_state(tasks, mtype, dynamics, parents)
    r, n = st.tasks.arrival.shape
    max_events = params.max_events or (4 * n + 16)
    if dynamics is not None and params.max_events is None:
        # every down interval contributes at most 2 extra events
        max_events += 2 * dynamics.down_start.shape[-1] * mtype.shape[-1]
    if parents is not None and params.max_events is None:
        # every cascade echoes at most one extra event a cancelled task
        max_events += n
    n_m = mtype.shape[-1]
    if params.trace:
        k = dynamics.down_start.shape[-1] if dynamics is not None else 0
        cap = params.trace_capacity or T.row_capacity_bound(
            n, params.lcap, n_m, k)
        st.trace = T.make_buffer(r, cap, max_events, n_m, mtype.device)
    if params.metrics:
        st.metrics = ME.init(params.metrics_spec, r, mtype.device)
    if r == 0 or n == 0 or max_events <= 0:
        return st
    deps = None if parents is None else (parents, S.dep_index(parents))
    plan = P.Plan.make(policy_ids.to(torch.int32), st, tables,
                       policy_params)
    const = P.expected_tables(st, tables)
    rows = torch.arange(r, device=mtype.device)[:, None]
    p_active = tables.power[rows, st.machines.mtype.long(), 1] * \
        st.machines.power_scale
    transitions = sorted_transitions(dynamics) if dynamics is not None \
        else None
    act = torch.ones(r, dtype=torch.bool, device=mtype.device)
    up = None
    more = True
    while more:
        t = _next_event_time(st, transitions, deps)
        st.time = torch.where(act, t, st.time)
        _completions(st, p_active, act)
        if dynamics is not None:
            _availability(st, dynamics, p_active, act)
            up = S.machine_up(dynamics, st.time)
        if deps is not None:
            _release(st, deps, act, stats)
        _arrivals(st, params.qcap, act)
        _deadline_drops(st, p_active, act)
        more = _drain(st, tables, plan, params, const, act, max_events,
                      stats, up)
        _start_tasks(st, tables, act, up)
        if st.trace is not None:
            T.snapshot(st.trace, st, act)
        if st.metrics is not None:
            ME.observe_event(st.metrics, st.tasks, act)
        st.n_events = st.n_events + act.to(torch.int32)
        act = (st.n_live > 0) & (st.n_events < max_events)
        stats.events += 1
    if st.metrics is not None:
        # per-task samples fold once the table is final: every task is
        # terminal once, so the counts equal a fold at each terminal event
        st.metrics = ME.fold_tasks(st.metrics, st.tasks)
    return st


def make_tables(eet: EETTable | np.ndarray, power: np.ndarray,
                n_tasks: int, *, noise: np.ndarray | None = None,
                rank: np.ndarray | None = None,
                device="cuda") -> S.StaticTables:
    """One-replica (leading axis 1) static tables on ``device``; ``eet``
    is an ``EETTable`` (or anything with an ``eet`` array) or an array."""
    dev = resolve_device(device)
    eet_arr = np.asarray(getattr(eet, "eet", eet))   # an EETTable or array
    if noise is None:
        noise = np.ones((n_tasks,), np.float32)
    if rank is None:
        rank = np.zeros((n_tasks,), np.float32)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32)[None], device=dev)

    return S.StaticTables(eet=put(eet_arr), power=put(power),
                          noise=put(noise), rank=put(rank))


def simulate(workload, eet: EETTable, power: np.ndarray,
             machine_types, policy: str = "mct", *, lcap: int = 4,
             qcap: int | None = None, cancel_infeasible: bool = True,
             noise: np.ndarray | None = None,
             dynamics: S.MachineDynamics | None = None,
             trace: bool = False, trace_capacity: int | None = None,
             metrics: bool = False,
             metrics_spec: ME.MetricsSpec | None = None,
             policy_params=None, device="cuda") -> S.SimState:
    """One replica, named policy; returns a one-replica (leading axis 1)
    final state.  ``workload`` is a ``workload.Workload`` or a
    ``workload.Workflow``, whose parent table goes to the release phase
    and whose HEFT ranks come from the EET row means.  ``dynamics``
    (leading axis 1, on ``device``, e.g. from
    ``workload.Scenario.dynamics``) makes the fleet dynamic.
    ``trace=True`` attaches a ``trace.TraceBuffer`` (``.trace``, the
    input of ``core/viz.py``); ``metrics=True`` attaches
    ``metrics.SimMetrics`` instruments (``.metrics``), with
    ``metrics_spec`` overriding the bucket and window geometry.
    ``policy_params`` supplies the ``mlp``/``linear`` weights."""
    dev = resolve_device(device)
    parents = rank = None
    if isinstance(workload, Workflow):
        eet_arr = np.asarray(getattr(eet, "eet", eet))
        parents = torch.as_tensor(workload.parents[None], device=dev)
        rank = workload.ranks(eet_arr.mean(axis=1))
        workload = workload.workload
    params = SimParams(lcap=lcap, qcap=qcap or (1 << 30),
                       cancel_infeasible=cancel_infeasible, trace=trace,
                       trace_capacity=trace_capacity, metrics=metrics,
                       metrics_spec=metrics_spec)
    tables = make_tables(eet, power, workload.n_tasks, noise=noise,
                         rank=rank, device=dev)
    mtype = torch.as_tensor(np.asarray(machine_types, np.int32)[None],
                            device=dev)
    pid = torch.tensor([P.POLICY_IDS[policy]], dtype=torch.int32,
                       device=dev)
    return run_sweep(workload.to_task_table(dev), mtype, tables, pid, params,
                     dynamics=dynamics, parents=parents,
                     policy_params=policy_params)
