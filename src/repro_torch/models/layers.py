"""Shared model primitives: norms, RoPE, gated MLPs, embeddings.

The subset of ``repro/models/layers.py`` that the dense and MoE
transformers use: RMSNorm and bias-free gated MLPs, which the two ported
configurations need (LayerNorm and the plain MLP wait for the
configurations that use them).  Parameters are plain dicts of tensors
with the reference's names and layouts (``wi`` (d, 2, d_ff) holds gate
and up side by side).  Initializers draw from an explicit
``torch.Generator`` at the reference's scales: fan-in ``fan**-0.5``,
embeddings ``d**-0.5``, norms and biases zero.  They give other numbers
than ``jax.random`` for the same seed; tests carry the reference's
weights across with ``interop.lm_params_from_numpy``.  The ``Ax`` logical-axis annotations
are sharding machinery and wait for the ``torch.distributed`` slice.

Products take the activation's dtype for both operands, as the
reference's ``einsum(..., preferred_element_type=float32)`` does, and
PyTorch accumulates them in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DEFAULT_INIT_STD = 0.02


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, *, std=DEFAULT_INIT_STD,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, std^2) drawn from ``gen`` on its device."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)


def fanin_init(gen: torch.Generator, shape, *, fan_in=None,
               dtype=torch.float32) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    return normal_init(gen, shape, std=fan ** -0.5, dtype=dtype)


def zeros_init(shape, *, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def _check_norm(kind: str) -> None:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported to "
                                  "repro_torch yet (ROADMAP queue A16)")


def init_norm(kind: str, d: int, *, dtype=torch.float32,
              device=None) -> dict:
    _check_norm(kind)
    return {"scale": zeros_init((d,), dtype=dtype, device=device)}


def apply_norm(kind: str, p: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the ``(1 + scale)`` form, f32 inside."""
    _check_norm(kind)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                   device=device) / hd)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    ang = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Gated MLP
# --------------------------------------------------------------------------
def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def init_gated_mlp(gen: torch.Generator, d: int, d_ff: int, *,
                   dtype=torch.float32) -> dict:
    # fused gate+up projection: (d, 2, d_ff)
    return {"wi": fanin_init(gen, (d, 2, d_ff), fan_in=d, dtype=dtype),
            "wo": fanin_init(gen, (d_ff, d), dtype=dtype)}


def apply_gated_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    d_ff = p["wi"].shape[-1]
    wi = p["wi"].to(x.dtype).reshape(p["wi"].shape[0], 2 * d_ff)
    h = (x @ wi).unflatten(-1, (2, d_ff))
    h = (act_fn(act)(h[..., 0, :]) * h[..., 1, :]).to(x.dtype)
    return h @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32) -> dict:
    # 1/sqrt(d): unit-variance activations after the (optional) sqrt(d)
    # embed scale, and sane logits when the table is tied as the unembedding.
    return {"table": normal_init(gen, (vocab, d), std=d ** -0.5,
                                 dtype=dtype)}


def embed_tokens(p: dict, tokens: torch.Tensor, *, scale: bool,
                 dtype=torch.bfloat16) -> torch.Tensor:
    x = p["table"][tokens].to(dtype)
    if scale:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=dtype)
    return x


def unembed(p_head: dict | None, p_embed: dict, x: torch.Tensor,
            *, softcap: float = 0.0) -> torch.Tensor:
    """-> f32 logits over the vocabulary."""
    table = p_head["w"] if p_head is not None else p_embed["table"].T
    logits = (x @ table.to(x.dtype)).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def init_lm_head(gen: torch.Generator, d: int, vocab: int, *,
                 dtype=torch.float32) -> dict:
    return {"w": fanin_init(gen, (d, vocab), dtype=dtype)}
