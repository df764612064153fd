"""Wrappers of the CUDA dispatch and event-loop kernels.

Replaces the five Pallas kernels of ``repro/kernels/sched_argmin.py``:
``masked_argmin`` (:89), ``fused_minmin`` (:227), ``fused_maxmin``
(:427), ``fused_start_pick`` (:315) and ``fused_event_bounds`` (:388).
The kernels live in ``csrc/sched_argmin.cu``; its header says how the
sequential-grid carry of the Pallas versions became a (value, index)
reduction inside one replica's warp or CTA.

What bounds them on the H100 is bytes, and at the engine's shapes launch
latency below that: a call moves a few KB to a few hundred KB per
replica and does one or two operations per byte.  So the designs aim at
one round trip to memory, few barriers and one wave of CTAs, and the
wrappers at little host work per call.  Four kernels have two layouts,
which the wrapper picks on the host from the shapes:

* ``masked_argmin``: rows of ``len = N*M <= ARGMIN_WARP_MAX`` (the
  engine's drain calls it on (R, 1, M) rows) take a warp per replica,
  each lane a contiguous chunk, no shared memory and no barrier, with
  16-byte loads where ``len % 4 == 0`` and the rows are aligned; longer
  rows take a 256-thread CTA per replica.
* ``fused_minmin`` and ``fused_maxmin`` (``type_layout``): a task's
  completion row depends only on its type, so where ``T <= N`` and the
  T-entry (minimum, machine) table fits in shared memory (``T <=
  TYPE_TABLE_MAX``) a CTA per replica reduces each type over the
  machines once and then scans the tasks, 4 a thread with 16-byte loads
  where ``N % 4 == 0`` and the rows are aligned: T*M + N work in place
  of N*M.  Otherwise each thread walks whole task rows.
* ``fused_start_pick`` (``pick_layout``): where the 8 per-warp tables of
  M + 1 64-bit keys fit in 48 KB (``M <= PICK_WARP_MAX``), a warp per
  replica, 8 replicas a CTA, reads the statuses whole (16-byte loads
  where ``N % 4 == 0`` and the rows are aligned) and machine and seq
  only for queued tasks; more machines take a 256-thread CTA per
  replica.

Every wrapper takes a leading replica axis R and computes, per replica,
what the Pallas function computes for one.  A tensor on the CPU goes to
the plain PyTorch version in ``ref.py``; a CUDA tensor launches the
kernel (building it on first use) or raises — there is no fallback.
``launches`` counts kernel launches only, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

NAMES = ("masked_argmin", "fused_minmin", "fused_maxmin",
         "fused_start_pick", "fused_event_bounds")
ARGMIN_WARP_MAX = 1024          # longest row a warp per replica takes
# (f32, i32) type entries that fit, beside the 384 static bytes of the
# kernel's block reduction, in the 48 KB a launch gets without opting in
TYPE_TABLE_MAX = (48 * 1024 - 384) // 8
# machines whose 64-bit keys, and a spare key for machines outside [0, M),
# fit for each of a CTA's 8 warps in 48 KB
PICK_WARP_MAX = 48 * 1024 // (8 * 8) - 1

launches = dict.fromkeys(NAMES, 0)


def reset_launches() -> None:
    for name in NAMES:
        launches[name] = 0


def _count(name: str) -> None:
    launches[name] += 1


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on a mix or on
    another device type."""
    dev = tensors[0].device
    if all(t.device == dev for t in tensors[1:]) \
            and dev.type in ("cpu", "cuda"):
        return dev.type == "cuda"
    raise ValueError(f"kernel inputs must all be on one CPU or CUDA device, "
                     f"got {sorted(str(t.device) for t in tensors)}")


def _expect(x: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str
            ) -> torch.Tensor:
    if x.dtype != dtype or x.shape != shape:
        raise ValueError(f"{what}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _stream(x: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``x``'s device, as the handle the
    launchers take.  ``torch.cuda.current_stream().cuda_stream`` gives
    the same handle but builds a ``Stream`` object on every call, which
    costs more host time than the launch itself; this is the call that
    PyTorch's own generated kernel launchers make."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def argmin_layout(length: int, values_ptr: int, mask_ptr: int) -> int:
    """``masked_argmin``'s layout for rows of ``length`` cells: 0 a CTA
    per replica, 1 a warp per replica, 2 a warp per replica with 16-byte
    loads (``length % 4 == 0`` and aligned rows)."""
    if length > ARGMIN_WARP_MAX:
        return 0
    return 2 if length % 4 == 0 and values_ptr % 16 == 0 \
        and mask_ptr % 4 == 0 else 1


def type_layout(n: int, t: int, type_ptr: int, in_batch_ptr: int) -> int:
    """``fused_minmin``'s and ``fused_maxmin``'s layout for N tasks of T
    types: 0 per task, 1 per type, 2 per type with 16-byte task loads
    (``n % 4 == 0`` and aligned rows)."""
    if t > n or t > TYPE_TABLE_MAX:
        return 0
    return 2 if n % 4 == 0 and type_ptr % 16 == 0 \
        and in_batch_ptr % 4 == 0 else 1


def pick_layout(n: int, m: int, status_ptr: int) -> int:
    """``fused_start_pick``'s layout for N tasks on M machines: 0 a CTA
    per replica, 1 a warp per replica, 2 a warp per replica with 16-byte
    status loads (``n % 4 == 0`` and aligned rows)."""
    if m > PICK_WARP_MAX:
        return 0
    return 2 if n % 4 == 0 and status_ptr % 16 == 0 else 1


def masked_argmin(values: torch.Tensor, mask: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, N, M) values + bool mask -> (flat_idx (R,) i32, min (R,) f32).

    Per replica: empty mask -> (-1, BIG); otherwise identical (index and
    value) to ``argmin(where(mask, values, BIG))`` row-major."""
    if not _on_cuda(values, mask):
        return ref.masked_argmin_ref(values, mask)
    if values.dtype != torch.float32:
        values = values.to(torch.float32)
    values = values.contiguous()
    mask = _expect(mask, torch.bool, values.shape, "mask")
    r = values.shape[0]
    length = math.prod(values.shape[1:])
    if length >= 2**31:
        raise ValueError("masked_argmin: N*M must fit in int32")
    dev = values.device
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    vmin = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        vp, mp = values.data_ptr(), mask.data_ptr()
        build.check(build.load().e2c_masked_argmin(
            vp, mp, r, length, argmin_layout(length, vp, mp),
            idx.data_ptr(), vmin.data_ptr(), _stream(values)),
            "masked_argmin")
        _count("masked_argmin")
    return idx, vmin


def fused_minmin(avail: torch.Tensor, in_batch: torch.Tensor,
                 room: torch.Tensor, type_id: torch.Tensor,
                 eet_m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-Min pair -> (flat_idx (R,) i32, min (R,) f32).

    ``avail`` (R, M), ``in_batch`` (R, N) bool, ``room`` (R, M) bool,
    ``type_id`` (R, N) i32 (each in ``[0, T)``), ``eet_m`` (R, T, M) the
    speed-scaled EET table.  The (N, M) completion matrix is never
    stored.  No valid (in_batch, room) pair -> (-1, BIG)."""
    if not _on_cuda(avail, in_batch, room, type_id, eet_m):
        return ref.fused_minmin_ref(avail, in_batch, room, type_id, eet_m)
    r, m = avail.shape
    n = in_batch.shape[1]
    t = eet_m.shape[1]
    if n * m >= 2**31:
        raise ValueError("fused_minmin: N*M must fit in int32")
    avail = _expect(avail, torch.float32, (r, m), "avail")
    in_batch = _expect(in_batch, torch.bool, (r, n), "in_batch")
    room = _expect(room, torch.bool, (r, m), "room")
    type_id = _expect(type_id, torch.int32, (r, n), "type_id")
    eet_m = _expect(eet_m, torch.float32, (r, t, m), "eet_m")
    idx = torch.empty(r, dtype=torch.int32, device=avail.device)
    vmin = torch.empty(r, dtype=torch.float32, device=avail.device)
    if r:
        tp, ip = type_id.data_ptr(), in_batch.data_ptr()
        build.check(build.load().e2c_fused_minmin(
            avail.data_ptr(), ip, room.data_ptr(), tp, eet_m.data_ptr(), r,
            n, m, t, type_layout(n, t, tp, ip), idx.data_ptr(),
            vmin.data_ptr(), _stream(avail)), "fused_minmin")
        _count("fused_minmin")
    return idx, vmin


def fused_maxmin(avail: torch.Tensor, in_batch: torch.Tensor,
                 room: torch.Tensor, type_id: torch.Tensor,
                 eet_m: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Max-Min pair -> (task (R,) i32, machine (R,) i32, score (R,) f32).

    The inputs of ``fused_minmin``.  Per replica, each in-batch task's
    best completion over the machines with room (first-index machine)
    is its score; the task of largest score wins, the first on ties.
    No valid (in_batch, room) pair -> (-1, -1, -BIG)."""
    if not _on_cuda(avail, in_batch, room, type_id, eet_m):
        return ref.fused_maxmin_ref(avail, in_batch, room, type_id, eet_m)
    r, m = avail.shape
    n = in_batch.shape[1]
    t = eet_m.shape[1]
    avail = _expect(avail, torch.float32, (r, m), "avail")
    in_batch = _expect(in_batch, torch.bool, (r, n), "in_batch")
    room = _expect(room, torch.bool, (r, m), "room")
    type_id = _expect(type_id, torch.int32, (r, n), "type_id")
    eet_m = _expect(eet_m, torch.float32, (r, t, m), "eet_m")
    # three allocations cost less host time than one split into views
    dev = avail.device
    task = torch.empty(r, dtype=torch.int32, device=dev)
    mach = torch.empty(r, dtype=torch.int32, device=dev)
    score = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        tp, ip = type_id.data_ptr(), in_batch.data_ptr()
        build.check(build.load().e2c_fused_maxmin(
            avail.data_ptr(), ip, room.data_ptr(), tp, eet_m.data_ptr(), r,
            n, m, t, type_layout(n, t, tp, ip), task.data_ptr(),
            mach.data_ptr(), score.data_ptr(), _stream(avail)),
            "fused_maxmin")
        _count("fused_maxmin")
    return task, mach, score


def fused_start_pick(status: torch.Tensor, machine: torch.Tensor,
                     seq: torch.Tensor, n_machines: int, *, in_mq: int = 2
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-machine FIFO head -> (pick (R, M) i32, has (R, M) bool):
    the lowest-``seq`` task queued on each machine, lowest id on ties."""
    if not _on_cuda(status, machine, seq):
        return ref.fused_start_pick_ref(status, machine, seq, n_machines,
                                        in_mq=in_mq)
    r, n = status.shape
    status = _expect(status, torch.int32, (r, n), "status")
    machine = _expect(machine, torch.int32, (r, n), "machine")
    seq = _expect(seq, torch.int32, (r, n), "seq")
    pick = torch.empty((r, n_machines), dtype=torch.int32,
                       device=status.device)
    has = torch.empty((r, n_machines), dtype=torch.bool,
                      device=status.device)
    if r and n_machines:
        sp = status.data_ptr()
        build.check(build.load().e2c_fused_start_pick(
            sp, machine.data_ptr(), seq.data_ptr(), r, n, n_machines, in_mq,
            pick_layout(n, n_machines, sp), pick.data_ptr(), has.data_ptr(),
            _stream(status)), "fused_start_pick")
        _count("fused_start_pick")
    return pick, has


def fused_event_bounds(status: torch.Tensor, arrival: torch.Tensor,
                       deadline: torch.Tensor, *, not_arrived: int = 0,
                       live_lo: int = 1, live_hi: int = 3
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-event candidates -> (t_arr (R,) f32, t_dl (R,) f32): the
    minimum arrival over ``not_arrived`` tasks and the minimum deadline
    over statuses ``live_lo..live_hi``; +inf when empty."""
    kw = {"not_arrived": not_arrived, "live_lo": live_lo,
          "live_hi": live_hi}
    if not _on_cuda(status, arrival, deadline):
        return ref.fused_event_bounds_ref(status, arrival, deadline, **kw)
    r, n = status.shape
    status = _expect(status, torch.int32, (r, n), "status")
    arrival = _expect(arrival, torch.float32, (r, n), "arrival")
    deadline = _expect(deadline, torch.float32, (r, n), "deadline")
    t_arr = torch.empty(r, dtype=torch.float32, device=status.device)
    t_dl = torch.empty(r, dtype=torch.float32, device=status.device)
    if r:
        build.check(build.load().e2c_fused_event_bounds(
            status.data_ptr(), arrival.data_ptr(), deadline.data_ptr(), r, n,
            not_arrived, live_lo, live_hi, t_arr.data_ptr(), t_dl.data_ptr(),
            _stream(status)), "fused_event_bounds")
        _count("fused_event_bounds")
    return t_arr, t_dl
