"""Wrapper of the CUDA grouped matrix product, and its plain version.

Replaces the Pallas kernel of ``repro/kernels/grouped_matmul.py``
(``grouped_matmul`` :50, body ``_gmm_kernel`` :29), with the signature of
``repro/kernels/ops.py::grouped_matmul``: lhs (G, C, D) x rhs (G, D, F)
with group sizes (G,) -> (G, C, F), rows at or past ``group_sizes[g]``
exactly 0.  It is the expert FFN of ``models/moe.py``.  The kernel lives
in ``csrc/grouped_matmul.cu``; its header says what bounds it and how a
tile of padding rows costs no loads.

A tensor on the CPU goes to ``grouped_matmul_ref``, the masked einsum of
``repro/kernels/ref.py::grouped_matmul_ref``; a CUDA tensor launches the
kernel (building it on first use) or raises — there is no fallback.
``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAMES = ("grouped_matmul",)
DTYPES = (torch.float32, torch.bfloat16)
SIZE_DTYPES = (torch.int32, torch.int64)

launches = dict.fromkeys(NAMES, 0)


def reset_launches() -> None:
    for name in NAMES:
        launches[name] = 0


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Masked batched product in f32, output in lhs's dtype."""
    c = lhs.shape[1]
    valid = (torch.arange(c, device=lhs.device)[None, :]
             < group_sizes[:, None])[..., None]               # (G, C, 1)
    lhs = torch.where(valid, lhs, 0)
    out = torch.einsum("gcd,gdf->gcf", lhs.float(), rhs.float())
    return torch.where(valid, out, 0.0).to(lhs.dtype)


def _check(lhs: torch.Tensor, rhs: torch.Tensor,
           group_sizes: torch.Tensor) -> None:
    if lhs.dim() != 3 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(f"grouped_matmul: expected lhs (G, C, D), rhs "
                         f"(G, D, F), sizes (G,), got {tuple(lhs.shape)}, "
                         f"{tuple(rhs.shape)}, {tuple(group_sizes.shape)}")
    if lhs.dtype not in DTYPES or rhs.dtype != lhs.dtype:
        raise ValueError(f"grouped_matmul: lhs and rhs must both be float32 "
                         f"or both bfloat16, got {lhs.dtype}, {rhs.dtype}")
    if group_sizes.dtype not in SIZE_DTYPES:
        raise ValueError(f"grouped_matmul: group sizes must be int32 or "
                         f"int64, got {group_sizes.dtype}")
    g, _, d = lhs.shape
    if rhs.shape[0] != g or rhs.shape[1] != d or group_sizes.shape[0] != g:
        raise ValueError(f"grouped_matmul: shapes do not match: lhs "
                         f"{tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, sizes "
                         f"{tuple(group_sizes.shape)}")
    devices = {lhs.device, rhs.device, group_sizes.device}
    if len(devices) != 1 or lhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul: inputs must all be on one CPU or "
                         f"CUDA device, got {sorted(map(str, devices))}")


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor, *, block_c: int = 128,
                   block_f: int = 128) -> torch.Tensor:
    """(G, C, D) x (G, D, F) + (G,) sizes -> (G, C, F) in lhs's dtype;
    ``block_c`` and ``block_f`` are accepted for the reference's
    signature and ignored: the kernel picks its own tiles."""
    del block_c, block_f
    _check(lhs, rhs, group_sizes)
    if lhs.device.type == "cpu":
        return grouped_matmul_ref(lhs, rhs, group_sizes)
    g, c, d = lhs.shape
    f = rhs.shape[2]
    if g > 65535 or c * max(d, f) >= 2**31 or d * f >= 2**31:
        raise ValueError("grouped_matmul: G must be at most 65535 and a "
                         "group's C*D, C*F and D*F below 2**31")
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((g, c, f), dtype=lhs.dtype, device=lhs.device)
    if out.numel():
        build.check(build.load("grouped_matmul").e2c_grouped_matmul(
            lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            g, c, d, f, int(lhs.dtype == torch.bfloat16),
            torch.cuda.current_stream(lhs.device).cuda_stream),
            "grouped_matmul", "grouped_matmul")
        launches["grouped_matmul"] += 1
    return out
