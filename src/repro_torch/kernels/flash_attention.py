"""Wrapper of the CUDA flash-attention kernel, and its plain version.

Replaces the Pallas kernel of ``repro/kernels/flash_attention.py``
(``flash_attention`` :92, body ``_flash_kernel`` :28), with the signature
of ``repro/kernels/ops.py::flash_attention``: q (BH, Sq, hd), k and v
(BH, Sk, hd), heads folded into the batch axis (GQA callers repeat KV
heads first), positions ``0..S-1`` in both q and k.  The kernel lives in
``csrc/flash_attention.cu``; its header says what bounds it on the H100
and how the Pallas kernel's sequential key-block carry and block skip
became a loop inside one CTA per (bh, query tile); a call of at most 4
query rows (a decode step's cross-attention) splits the keys over CTAs
instead and merges their blocks in a second kernel.

A tensor on the CPU goes to ``flash_attention_ref``, the dense masked
softmax of ``repro/kernels/ref.py::flash_attention_ref``, whose autograd
is the plain backward; a CUDA tensor launches the kernel (building it on
first use) or raises — there is no fallback.  On a CUDA tensor with grad
enabled and an input that requires grad, the call goes through
``FlashAttention`` (a ``torch.autograd.Function``): its forward launches
the kernel with the row statistics ``lse = m + log(l)`` written beside
the output, its backward launches ``flash_attention_bwd`` (the three
kernels of ``csrc/flash_attention_bwd.cu``: D = rowsum(dO * O), dK/dV,
dQ).  Without grad the forward runs as in serving, with no ``lse``.
``flash_attention_fwd_ref`` (output and ``lse``) and
``flash_attention_bwd_ref`` are the plain twins of the two training
launches, for the tests and ``chip_smoke.py``.  ``launches`` counts
kernel launches only: ``flash_attention`` one a forward call,
``flash_attention_bwd`` one a backward call (of three kernels).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NAMES = ("flash_attention", "flash_attention_bwd")
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


def _capped_logits(q, k, softcap):
    """Scaled (and softcapped) f32 logits, and tanh of the capped ones."""
    logits = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    if not softcap:
        return logits, None
    t = torch.tanh(logits / softcap)
    return softcap * t, t


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Dense masked softmax attention in f32, output in q's dtype."""
    logits, _ = _capped_logits(q, k, softcap)
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal,
                        window=window, device=q.device)
    logits = torch.where(mask, logits, NEG)
    w = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("bqk,bkh->bqh", w, v.float()).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """``flash_attention_ref`` and the rows' f32 ``lse`` (BH, Sq): the
    log-sum-exp of the visible scaled logits, 0 for a row with none."""
    x, _ = _capped_logits(q, k, softcap)
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal,
                        window=window, device=q.device)
    lse = torch.logsumexp(torch.where(mask, x, -torch.inf), dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, 0.0)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) in the inputs' dtype from the forward's output ``o``
    and row statistics ``lse``, in f32: P = exp(x - lse) on the visible
    pairs, dV = P^T dO, dS = P (dO V^T - rowsum(dO O)), times 1 - tanh^2
    under the softcap, times hd**-0.5; dQ = dS K, dK = dS^T Q."""
    x, t = _capped_logits(q, k, softcap)
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal,
                        window=window, device=q.device)
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    dof = do.float()
    dv = torch.einsum("bqk,bqh->bkh", p, dof)
    dp = torch.einsum("bqh,bkh->bqk", dof, v.float())
    ds = p * (dp - (dof * o.float()).sum(dim=-1, keepdim=True))
    if t is not None:
        ds = ds * (1 - t * t)
    ds = ds * (q.shape[-1] ** -0.5)
    dq = torch.einsum("bqk,bkh->bqh", ds, k.float())
    dk = torch.einsum("bqk,bqh->bkh", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _forward(q, k, v, causal: bool, window: int, softcap: float,
             with_lse: bool):
    """One launch of the forward kernel -> (out, lse or None)."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if bh > 65535:
        raise ValueError("flash_attention: BH must be at most 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if bh and sq:
        lib = build.load("flash_attention")
        scratch_n = lib.e2c_flash_attention_scratch(bh, sq, sk, hd)
        if with_lse and scratch_n:
            raise ValueError(f"flash_attention: the gradient needs the tiled "
                             f"route, and {sq} query rows take the split-key "
                             f"decode route (at most 4 rows)")
        # the decode route's partial key blocks (none for the tiled kernel)
        scratch = torch.empty(scratch_n, dtype=torch.float32,
                              device=q.device)
        build.check(lib.e2c_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), None if lse is None else lse.data_ptr(), bh,
            sq, sk, hd, int(causal), int(window), hd ** -0.5, float(softcap),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream),
            "flash_attention", "flash_attention")
        launches["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """-> (dq, dk, dv) in the inputs' dtype, from the forward's ``o`` and
    ``lse`` and the output's gradient ``do``.
    A CPU tensor goes to ``flash_attention_bwd_ref``; a CUDA tensor
    launches the three backward kernels (one count) or raises."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: o and do must be "
                         f"{tuple(q.shape)} and lse {tuple(q.shape[:2])} "
                         f"f32, got {tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if bh > 65535:
        raise ValueError("flash_attention_bwd: BH must be at most 65535")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o, do = o.to(q.dtype).contiguous(), do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if bh and sq and sk:
        lib = build.load("flash_attention_bwd")
        delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        build.check(lib.e2c_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, sq, sk, hd, int(causal),
            int(window), hd ** -0.5, float(softcap),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream),
            "flash_attention_bwd", "flash_attention_bwd")
        launches["flash_attention_bwd"] += 1
    else:
        for g in (dq, dk, dv):
            g.zero_()
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel's forward (with ``lse``) and backward as one
    differentiable call on CUDA tensors; the output's
    ``grad_fn.saved_tensors`` are (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window,
                                         softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(BH, Sq, hd) x (BH, Sk, hd)^2 -> (BH, Sq, hd) in q's dtype.

    Scaled by ``hd**-0.5``, optional ``softcap * tanh(x / softcap)``;
    masks ``kpos <= qpos`` (causal), ``qpos - kpos < window`` and
    ``kpos < Sk``; a row with no visible key is 0.  ``block_q`` and
    ``block_k`` are accepted for the reference's signature and ignored:
    the kernel picks its own tiles.  Differentiable on both devices."""
    del block_q, block_k
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, False)[0]
