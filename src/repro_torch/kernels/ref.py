"""Plain PyTorch versions of the dispatch and event-loop kernels, and of
the learned policies' multiply-add.

Each function computes, batched over a leading replica axis R, exactly
what its counterpart in ``repro.kernels.ref`` computes for one replica:
the same first-index tie-breaks, the same masked-as-``BIG`` semantics and
the same sentinels.  The kernel wrappers in ``sched_argmin.py`` use them
for tensors on the CPU, and the tests and ``chip_smoke.py`` hold each
CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.reduce import fma, signed_min

BIG = 1e30
INT_MAX = 2**31 - 1


def masked_argmin_ref(values: torch.Tensor, mask: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, N, M) values + bool mask -> (flat_idx (R,) i32, min (R,) f32).

    Per replica, identical to ``argmin(where(mask, values, BIG))`` over
    the row-major flattening when the mask has a True cell; an all-False
    mask returns the (-1, BIG) sentinel."""
    r = values.shape[0]
    masked = torch.where(mask, values.to(torch.float32), BIG).reshape(r, -1)
    flat = torch.argmin(masked, dim=1)
    found = mask.reshape(r, -1).any(1)
    idx = torch.where(found, flat, -1).to(torch.int32)
    vmin = torch.where(found, masked.gather(1, flat[:, None])[:, 0], BIG)
    return idx, vmin


def completion_ref(avail: torch.Tensor, in_batch: torch.Tensor,
                   room: torch.Tensor, type_id: torch.Tensor,
                   eet_m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, N, M) completion times ``avail[m] + eet_m[type_id[n], m]`` and
    the (in_batch & room) pair mask."""
    m = avail.shape[-1]
    rows = eet_m.to(torch.float32).gather(
        1, type_id.long()[:, :, None].expand(-1, -1, m))
    comp = avail.to(torch.float32)[:, None, :] + rows
    return comp, in_batch[:, :, None] & room[:, None, :]


def fused_minmin_ref(avail, in_batch, room, type_id, eet_m):
    """Min-Min pair via the materialized (R, N, M) path: gather the
    speed-scaled EET rows, add availability, mask, flat argmin."""
    comp, mask = completion_ref(avail, in_batch, room, type_id, eet_m)
    return masked_argmin_ref(comp, mask)


def fused_maxmin_ref(avail, in_batch, room, type_id, eet_m):
    """Max-Min (task, machine, score) via the materialized (R, N, M)
    path: each task's masked row minimum (-0.0 below +0.0, as the
    reference's ``min``) and its first-index machine, then the first
    in-batch task of largest row minimum; no valid pair -> (-1, -1,
    -BIG).  -> (task (R,) i32, machine (R,) i32, score (R,) f32)."""
    comp, mask = completion_ref(avail, in_batch, room, type_id, eet_m)
    c = torch.where(mask, comp, BIG)
    rowmin = signed_min(c, 2)                                 # (R, N)
    rowarg = torch.argmin(c, dim=2)                           # first index
    score = torch.where(in_batch, rowmin, -BIG)
    t = torch.argmax(score, dim=1)                            # first max
    found = mask.flatten(1).any(1)
    pick = rowarg.gather(1, t[:, None])[:, 0]
    best = score.gather(1, t[:, None])[:, 0]
    return (torch.where(found, t, -1).to(torch.int32),
            torch.where(found, pick, -1).to(torch.int32),
            torch.where(found, best, -BIG))


def fused_start_pick_ref(status: torch.Tensor, machine: torch.Tensor,
                         seq: torch.Tensor, n_machines: int, *,
                         in_mq: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-machine FIFO head: mask seqs of tasks not queued on the machine
    with INT_MAX, column argmin (first row on ties — lowest task id), plus
    the any-queued flag.  -> (pick (R, M) i32, has (R, M) bool)."""
    ids = torch.arange(n_machines, device=status.device)
    queued = (status == in_mq)[:, :, None] & (machine[:, :, None] == ids)
    seqs = torch.where(queued, seq[:, :, None], INT_MAX)
    return torch.argmin(seqs, dim=1).to(torch.int32), queued.any(1)


def fused_event_bounds_ref(status: torch.Tensor, arrival: torch.Tensor,
                           deadline: torch.Tensor, *, not_arrived: int = 0,
                           live_lo: int = 1, live_hi: int = 3
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-event minima: arrival over NOT_ARRIVED tasks and deadline over
    the live status range, per replica; +inf when empty.  -0.0 orders
    below +0.0, as in the reference's ``min``."""
    inf = float("inf")
    t_arr = signed_min(torch.where(status == not_arrived, arrival, inf), 1)
    live = (status >= live_lo) & (status <= live_hi)
    t_dl = signed_min(torch.where(live, deadline, inf), 1)
    return t_arr, t_dl


def fma_ref(x: torch.Tensor, w: torch.Tensor, acc: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``x * w + acc`` over broadcast operands, rounded once:
    ``reduce.fma`` (exact in float64, rounded to odd), the CPU twin of
    ``csrc/fma.cu``'s ``__fmaf_rn``."""
    return fma(x, w, acc)
