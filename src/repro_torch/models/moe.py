"""Mixture-of-Experts layer on one device, expert FFN through the kernel.

The single-device path of ``repro/models/moe.py`` (``_moe_local`` with
``model_axis=None``): token-choice top-k routing with a fixed per-expert
capacity, the slot of a (token, choice) pair inside its expert's buffer
being its running rank (one cumsum).  Expert parallelism over a mesh
waits for the ``torch.distributed`` slice.

The expert FFN always goes through the grouped-matmul kernel's wrapper,
twice: ``buf (E, C, D)`` x ``w_in`` viewed as ``(E, D, 2F)``, split into
gate and up, then ``act(gate) * up (E, C, F)`` x ``w_out (E, F, D)``.
``group_sizes[e] = min(count_e, C)`` is the number of kept slots of
expert e; kept slots are exactly ranks ``0..size-1`` and the buffer's
other rows are zeros, so the result equals the reference's dense einsum
(``act(0) * 0 = 0`` for silu and gelu) while the kernel skips the empty
rows and groups.  The reference documents this kernel route but computes
with two einsums (ROADMAP queue C).

Two orders are pinned to the reference's: ties in the top-k go to the
lower expert id, as ``jax.lax.top_k`` orders them (a stable descending
sort), and each token's k contributions are summed left to right from 0,
as the reference's CPU scatter-add does, not with atomics whose order
changes from run to run.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import grouped_matmul as GMM
from repro_torch.models import layers as L


def init_moe(gen: torch.Generator, d: int, mcfg: MoEConfig, *,
             dtype=torch.float32) -> dict:
    E, F = mcfg.n_experts, mcfg.d_ff_expert
    p = {
        "router": L.fanin_init(gen, (d, E), dtype=dtype),
        "w_in": L.fanin_init(gen, (E, d, 2, F), fan_in=d, dtype=dtype),
        "w_out": L.fanin_init(gen, (E, F, d), fan_in=F, dtype=dtype),
    }
    if mcfg.n_shared:
        p["shared"] = L.init_gated_mlp(gen, d,
                                       mcfg.d_ff_shared * mcfg.n_shared,
                                       dtype=dtype)
    return p


def capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * mcfg.top_k / mcfg.n_experts
                  * mcfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (f32 scalar)."""
    T = probs.shape[0]
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(top_e.numel(), device=probs.device))
    f = counts / max(T * top_e.shape[-1], 1)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def top_k(probs: torch.Tensor, k: int):
    """-> (values, indices) of the k largest per row, descending, ties to
    the lower index (the order of ``jax.lax.top_k``)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _moe_local(x, router_w, w_in, w_out, *, mcfg: MoEConfig, act: str,
               norm_topk: bool):
    """x: (B, S, D); w_in: (E, D, 2, F) -> (y (B, S, D), aux)."""
    B, S, D = x.shape
    T = B * S
    E, k = mcfg.n_experts, mcfg.top_k
    F = w_in.shape[-1]
    xf = x.reshape(T, D)

    logits = (xf @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E) f32
    top_p, top_e = top_k(probs, k)                              # (T, k)
    if norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    aux = load_balance_loss(probs, top_e, E)

    # (token, choice) pairs in token-major order, their rank in the expert
    pe = top_e.reshape(-1)                                      # (T*k,)
    pp = top_p.reshape(-1).float()
    ptok = torch.arange(T, device=x.device).repeat_interleave(k)
    onehot = torch.nn.functional.one_hot(pe, E).to(torch.int32)  # (T*k, E)
    rank = (torch.cumsum(onehot, dim=0) - 1).gather(1, pe[:, None])[:, 0]
    C = capacity(T, mcfg)
    keep = rank < C
    sizes = torch.clamp(onehot.sum(0), max=C).to(torch.int32)   # (E,)
    slot = pe * C + rank

    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    buf[slot[keep]] = xf[ptok[keep]]
    h = GMM.grouped_matmul(buf.reshape(E, C, D),
                           w_in.to(x.dtype).reshape(E, D, 2 * F), sizes)
    h = h.reshape(E, C, 2, F)
    h = (L.act_fn(act)(h[..., 0, :].float()) * h[..., 1, :].float()
         ).to(x.dtype)
    y = GMM.grouped_matmul(h, w_out.to(x.dtype), sizes).reshape(E * C, D)

    # combine: each token's k weighted outputs, summed left to right
    contrib = torch.where(keep, pp, 0.0)[:, None].to(x.dtype) \
        * y[torch.where(keep, slot, 0)]
    contrib = torch.where(keep[:, None], contrib, 0).reshape(T, k, D)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out.reshape(B, S, D), aux


def apply_moe(p: dict, x: torch.Tensor, mcfg: MoEConfig, act: str, *,
              norm_topk: bool = True):
    """x: (B, S, D) -> (y, aux_loss)."""
    y, aux = _moe_local(x, p["router"], p["w_in"], p["w_out"], mcfg=mcfg,
                        act=act, norm_topk=norm_topk)
    if "shared" in p:
        y = y + L.apply_gated_mlp(p["shared"], x, act)
    return y, aux
