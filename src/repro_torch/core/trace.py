"""In-loop trace capture, batched over replicas: the event stream behind
the visual layer.

The counterpart of ``repro.core.trace``.  A :class:`TraceBuffer` holds,
for each of R replicas,

* one **transition row** ``(time, kind, task, machine)`` per lifecycle
  transition (start / complete / preempt / requeue / miss / cancel), in
  the reference's order (phase order within a timestamp; machine-id or
  task-id order within a phase; the drain's and the release cascade's
  cancels after their loops), and
* one **fleet snapshot** per processed event (batch-queue depth,
  per-machine queue counts, running task ids, cumulative active energy).

Every array carries a leading replica axis.  ``record`` is a batched
masked append that runs on the device with no host read: the rank of a
row within its call is the exclusive ``cumsum`` of the mask, its
destination ``n_rows + rank``; rows at or past the capacity are dropped
while ``n_rows`` keeps counting, so overflow is visible and the first
``cap`` rows are exactly the rows the reference's windowed append keeps.
The row arrays hold one spare column past ``cap`` that takes the dropped
writes and is never read back.

The numpy accessors (``events``, ``snapshots``, ``overflowed``,
``segments``) act on one replica: :func:`replica_trace` cuts one out of
a batched buffer as numpy arrays, and :func:`resolve` does so for a
state or buffer of one replica (or the replica it is given).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import state as S

# Transition kinds (the edges of the status lifecycle).
EV_START = 0          # IN_MQ -> RUNNING                     (phase 6)
EV_COMPLETE = 1       # RUNNING -> COMPLETED                 (phase 1)
EV_PREEMPT = 2        # RUNNING/IN_MQ -> PREEMPTED (kill)    (phase 2)
EV_REQUEUE = 3        # RUNNING/IN_MQ -> IN_BATCH (repair)   (phase 2)
EV_MISS_QUEUE = 4     # IN_BATCH/IN_MQ -> MISSED_QUEUE       (phase 4)
EV_MISS_RUNNING = 5   # RUNNING -> MISSED_RUNNING            (phase 4)
EV_CANCEL = 6         # NOT_ARRIVED/IN_BATCH -> CANCELLED    (phases 2b, 3, 5)

EVENT_NAMES = {
    EV_START: "start",
    EV_COMPLETE: "complete",
    EV_PREEMPT: "preempt",
    EV_REQUEUE: "requeue",
    EV_MISS_QUEUE: "miss_queue",
    EV_MISS_RUNNING: "miss_running",
    EV_CANCEL: "cancel",
}

# kinds that close an execution segment opened by EV_START
SEGMENT_CLOSERS = (EV_COMPLETE, EV_PREEMPT, EV_REQUEUE, EV_MISS_RUNNING)


@dataclasses.dataclass
class TraceBuffer(S._Batched):
    """Fixed-capacity event log + per-event fleet snapshots.

    Batched (torch, leading axis R): the row arrays are (R, cap + 1), the
    last column a spare that takes dropped writes; ``n_rows`` is (R,).
    One replica (numpy, from :func:`replica_trace`): the row arrays are
    (cap,), ``n_rows`` a scalar, the snapshots lose their leading axis.
    """

    # transition rows (valid rows < min(n_rows, cap))
    ev_time: torch.Tensor     # f32 (R, cap + 1)
    ev_kind: torch.Tensor     # i32 (R, cap + 1)  EV_* code
    ev_task: torch.Tensor     # i32 (R, cap + 1)  task id
    ev_machine: torch.Tensor  # i32 (R, cap + 1)  machine id, -1 if none
    n_rows: torch.Tensor      # i32 (R,)  rows written (> cap: overflow)
    # per-event fleet snapshots (E = max_events)
    snap_time: torch.Tensor     # f32 (R, E)     event timestamp
    snap_batch: torch.Tensor    # i32 (R, E)     batch-queue depth
    snap_mq: torch.Tensor       # i32 (R, E, M)  machine-queue depths
    snap_running: torch.Tensor  # i32 (R, E, M)  running task ids (-1 idle)
    snap_energy: torch.Tensor   # f32 (R, E, M)  cumulative active energy
    cap: int = 0                # logical row capacity

    @property
    def capacity(self) -> int:
        return self.cap

    @property
    def max_events(self) -> int:
        return self.snap_time.shape[-1]


def row_capacity_bound(n_tasks: int, lcap: int,
                       n_machines: int = 0, n_intervals: int = 0) -> int:
    """Upper bound on transition rows for one replica: each task emits
    at most one terminal and one start row, plus a (start, requeue) pair
    per forced eviction, and each of the ``n_intervals`` down intervals
    of a machine evicts at most ``1 + lcap`` tasks."""
    return 2 * n_tasks + 2 * (1 + lcap) * n_machines * n_intervals + 16


def make_buffer(n_replicas: int, capacity: int, max_events: int,
                n_machines: int, device) -> TraceBuffer:
    """An empty buffer of ``n_replicas`` replicas on ``device``."""
    r, e, m = n_replicas, max_events, n_machines

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    rows = (r, capacity + 1)
    return TraceBuffer(
        ev_time=full(rows, 0.0, torch.float32),
        ev_kind=full(rows, -1, torch.int32),
        ev_task=full(rows, -1, torch.int32),
        ev_machine=full(rows, -1, torch.int32),
        n_rows=full((r,), 0, torch.int32),
        snap_time=full((r, e), 0.0, torch.float32),
        snap_batch=full((r, e), 0, torch.int32),
        snap_mq=full((r, e, m), 0, torch.int32),
        snap_running=full((r, e, m), -1, torch.int32),
        snap_energy=full((r, e, m), 0.0, torch.float32),
        cap=capacity,
    )


def _rows_of(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` (a number, (W,) or (R, W)) as an (R, W) tensor like ``like``
    (a number is filled on the device, not copied from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).expand(like.shape)
    return torch.full(like.shape, x, dtype=dtype, device=like.device)


def record(tb: TraceBuffer, time: torch.Tensor, kind, task: torch.Tensor,
           machine, mask: torch.Tensor) -> None:
    """In place: append one row per set bit of ``mask`` (R, W), in index
    order, to each replica's log.

    ``time`` is (R,); ``kind`` and ``machine`` are numbers or tensors
    aligned with ``mask``; ``task`` is aligned with ``mask``.  A row's
    destination is ``n_rows`` plus the exclusive running count of the
    mask; rows at or past ``cap`` go to the spare column, and ``n_rows``
    counts every row."""
    m = mask.to(torch.int32)
    dest = tb.n_rows[:, None] + torch.cumsum(m, 1, dtype=torch.int32) - m
    idx = torch.where(mask & (dest < tb.cap), dest, tb.cap).long()
    tb.ev_time.scatter_(1, idx, time[:, None].expand(mask.shape))
    tb.ev_kind.scatter_(1, idx, _rows_of(kind, mask, torch.int32))
    tb.ev_task.scatter_(1, idx, _rows_of(task, mask, torch.int32))
    tb.ev_machine.scatter_(1, idx, _rows_of(machine, mask, torch.int32))
    tb.n_rows += m.sum(1, dtype=torch.int32)


def _put_row(x: torch.Tensor, i: torch.Tensor, val: torch.Tensor,
             on: torch.Tensor) -> None:
    """In place: ``x[r, i[r]] = val[r]`` where ``on[r]``, for an (R, E)
    or (R, E, M) ``x``; ``i`` is clamped into range (off replicas write
    their own value back)."""
    idx = i.clamp(0, x.shape[1] - 1).long().view(-1, 1, *([1] * (x.dim()
                                                               - 2)))
    idx = idx.expand(-1, 1, *x.shape[2:])
    cur = x.gather(1, idx)
    new = val.reshape(cur.shape).to(x.dtype)
    on = on.view(-1, *([1] * (x.dim() - 1)))
    x.scatter_(1, idx, torch.where(on, new, cur))


def snapshot(tb: TraceBuffer, st: S.SimState, act: torch.Tensor) -> None:
    """In place: write the fleet snapshot of the event just processed,
    for the replicas ``act`` (R,) that processed one.  The row is
    ``st.n_events`` before its increment; a row at or past
    ``max_events`` is dropped."""
    on = act & (st.n_events < tb.max_events)
    i = st.n_events
    batch = (st.tasks.status == S.IN_BATCH).sum(1, dtype=torch.int32)
    _put_row(tb.snap_time, i, st.time, on)
    _put_row(tb.snap_batch, i, batch, on)
    _put_row(tb.snap_mq, i, st.mq_count, on)
    _put_row(tb.snap_running, i, st.machines.running, on)
    _put_row(tb.snap_energy, i, st.machines.energy, on)


# --------------------------------------------------------------------------
# Host-side accessors (numpy; one replica)
# --------------------------------------------------------------------------
def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batched(tb: TraceBuffer) -> bool:
    """Whether ``tb`` still carries the leading replica axis."""
    return np.ndim(_np(tb.n_rows)) == 1


def replica_trace(stacked, i: int) -> TraceBuffer:
    """Replica ``i`` of a batched buffer (or of a state's ``.trace``) as
    numpy arrays without the replica axis, the rows cut to ``cap``."""
    tb = getattr(stacked, "trace", None)
    tb = tb if tb is not None else stacked
    if not batched(tb):
        return tb
    cap = tb.cap
    rows = {f: _np(getattr(tb, f)[i])[:cap] for f in
            ("ev_time", "ev_kind", "ev_task", "ev_machine")}
    return TraceBuffer(
        **rows, n_rows=_np(tb.n_rows[i]),
        **{f: _np(getattr(tb, f)[i]) for f in
           ("snap_time", "snap_batch", "snap_mq", "snap_running",
            "snap_energy")},
        cap=cap)


def resolve(trace_or_state, replica: int = 0
            ) -> tuple[TraceBuffer, int | None]:
    """Accept a SimState (``.trace``) or a TraceBuffer; returns ``(one
    replica's buffer, its n_events or None)`` or raises a pointed error
    when tracing was off."""
    tb = getattr(trace_or_state, "trace", None)
    if tb is None and isinstance(trace_or_state, TraceBuffer):
        tb = trace_or_state
    if not isinstance(tb, TraceBuffer):
        raise ValueError(
            "no trace attached: run with SimParams(trace=True), "
            "simulate(..., trace=True) or ExperimentSpec(trace=True) "
            "first")
    n_events = getattr(trace_or_state, "n_events", None)
    if n_events is not None:
        n_events = _np(n_events)
        n_events = int(n_events[replica] if n_events.ndim else n_events)
    return replica_trace(tb, replica), n_events


def _one(tb: TraceBuffer) -> TraceBuffer:
    if batched(tb):
        if _np(tb.n_rows).shape[0] != 1:
            raise ValueError("a batched trace: pick a replica with "
                             "replica_trace(tb, i)")
        return replica_trace(tb, 0)
    return tb


def events(tb: TraceBuffer) -> dict[str, np.ndarray]:
    """Valid transition rows as numpy arrays, in emission order."""
    tb = _one(tb)
    n = min(int(tb.n_rows), tb.cap)
    return {
        "time": _np(tb.ev_time)[:n],
        "kind": _np(tb.ev_kind)[:n],
        "task": _np(tb.ev_task)[:n],
        "machine": _np(tb.ev_machine)[:n],
    }


def snapshots(tb: TraceBuffer, n_events: int | None = None
              ) -> dict[str, np.ndarray]:
    """Valid fleet snapshots as numpy arrays (one row per event).

    ``n_events`` trims to the processed-event count (pass the state's
    ``n_events``); by default the rows up to the last one whose time was
    written (the first event is at t >= 0 and times never decrease)."""
    tb = _one(tb)
    t = _np(tb.snap_time)
    if n_events is None:
        written = np.nonzero(t > 0)[0]
        n_events = int(written[-1]) + 1 if written.size else 1
    n = min(int(n_events), t.shape[-1])
    return {
        "time": t[:n],
        "batch": _np(tb.snap_batch)[:n],
        "mq": _np(tb.snap_mq)[:n],
        "running": _np(tb.snap_running)[:n],
        "energy": _np(tb.snap_energy)[:n],
    }


def overflowed(tb: TraceBuffer) -> bool:
    tb = _one(tb)
    return int(tb.n_rows) > tb.cap


def segments(tb: TraceBuffer) -> list[dict]:
    """Per-task execution segments from the event stream: each
    ``EV_START`` opens one on a machine and the task's next closing
    transition closes it, so an evicted-and-requeued task yields several
    (the Gantt chart's preemption split).  Returns dicts ``{task,
    machine, t0, t1, outcome}`` in close order; a segment still open at
    the end of the trace closes at the last event time with ``outcome =
    None``."""
    ev = events(tb)
    open_seg: dict[int, tuple[int, float]] = {}
    out: list[dict] = []
    for time, kind, task, machine in zip(ev["time"], ev["kind"],
                                         ev["task"], ev["machine"]):
        task = int(task)
        kind = int(kind)
        if kind == EV_START:
            open_seg[task] = (int(machine), float(time))
        elif kind in SEGMENT_CLOSERS and task in open_seg:
            m, t0 = open_seg.pop(task)
            out.append({"task": task, "machine": m, "t0": t0,
                        "t1": float(time), "outcome": kind})
    last_t = float(ev["time"][-1]) if ev["time"].size else 0.0
    for task, (m, t0) in sorted(open_seg.items()):
        out.append({"task": task, "machine": m, "t0": t0, "t1": last_t,
                    "outcome": None})
    return out
