"""Wrapper of the CUDA flash-attention kernel, and its plain version.

Replaces the Pallas kernel of ``repro/kernels/flash_attention.py``
(``flash_attention`` :92, body ``_flash_kernel`` :28), with the signature
of ``repro/kernels/ops.py::flash_attention``: q (BH, Sq, hd), k and v
(BH, Sk, hd), heads folded into the batch axis (GQA callers repeat KV
heads first), positions ``0..S-1`` in both q and k.  The kernel lives in
``csrc/flash_attention.cu``; its header says what bounds it on the H100
and how the Pallas kernel's sequential key-block carry and block skip
became a loop inside one CTA per (bh, query tile).

A tensor on the CPU goes to ``flash_attention_ref``, the dense masked
softmax of ``repro/kernels/ref.py::flash_attention_ref``; a CUDA tensor
launches the kernel (building it on first use) or raises — there is no
fallback.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAMES = ("flash_attention",)
NEG = -1e30
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)

launches = dict.fromkeys(NAMES, 0)


def reset_launches() -> None:
    for name in NAMES:
        launches[name] = 0


def visible_mask(sq: int, sk: int, *, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """(Sq, Sk) bool: the (query, key) pairs the kernel attends."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Dense masked softmax attention in f32, output in q's dtype."""
    hd = q.shape[-1]
    logits = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) \
        * (hd ** -0.5)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal,
                        window=window, device=q.device)
    logits = torch.where(mask, logits, NEG)
    w = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("bqk,bkh->bqh", w, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: q, k, v must be (BH, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: shapes do not match: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if not 0 < q.shape[2] <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {q.shape[2]} is not "
                         f"in 1..{MAX_HEAD_DIM}")
    if len({q.device, k.device, v.device}) != 1 \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: inputs must all be on one CPU "
                         f"or CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(BH, Sq, hd) x (BH, Sk, hd)^2 -> (BH, Sq, hd) in q's dtype.

    Scaled by ``hd**-0.5``, optional ``softcap * tanh(x / softcap)``;
    masks ``kpos <= qpos`` (causal), ``qpos - kpos < window`` and
    ``kpos < Sk``; a row with no visible key is 0.  ``block_q`` and
    ``block_k`` are accepted for the reference's signature and ignored:
    the kernel picks its own tiles."""
    del block_q, block_k
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if bh > 65535:
        raise ValueError("flash_attention: BH must be at most 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if bh and sq:
        build.check(build.load("flash_attention").e2c_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, hd, int(causal), int(window), hd ** -0.5, float(softcap),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream),
            "flash_attention", "flash_attention")
        launches["flash_attention"] += 1
    return out
