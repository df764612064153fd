"""Shared model primitives: norms, RoPE, MLPs, embeddings.

The serving half of ``repro/models/layers.py``: RMSNorm and its
head-wise QK-norm form, LayerNorm, the xLSTM blocks' GroupNorm, gated
and plain (biased) MLPs, linear maps and the causal temporal
convolution of the RG-LRU and xLSTM blocks.  Parameters are plain dicts
of tensors with the reference's names and layouts (``wi`` (d, 2, d_ff)
holds gate and up side by side).  Initializers draw from an explicit
``torch.Generator`` at the reference's scales: fan-in ``fan**-0.5``,
embeddings ``d**-0.5``; RMSNorm scales, biases and conv taps zero,
LayerNorm and GroupNorm scales one.  They give other numbers than
``jax.random`` for the same seed; tests carry the reference's weights
across with ``interop.lm_params_from_numpy``.  The ``Ax`` logical-axis
annotations are sharding machinery and wait for the
``torch.distributed`` slice.

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
def init_norm(kind: str, d: int, *, dtype=torch.float32,
              device=None) -> dict:
    if kind == "rmsnorm":                               # (1 + scale) form
        return {"scale": zeros_init((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": zeros_init((d,), dtype=dtype, device=device)}


def apply_norm(kind: str, p: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the ``(1 + scale)`` form, or LayerNorm with scale and
    bias (``kind == "layernorm"``, the population variance); f32 inside."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    return y.to(x.dtype)


def rms_norm_headwise(scale: torch.Tensor, x: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """QK-norm: RMSNorm over the last (head_dim) axis, one shared
    ``(1 + scale)``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, n_groups: int, scale: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis (xLSTM blocks), no bias, f32
    inside."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.reshape(*lead, d) * scale.float()).to(x.dtype)


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
# Linear maps and the gated MLP
# --------------------------------------------------------------------------
def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in ``x``'s dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


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


def init_plain_mlp(gen: torch.Generator, d: int, d_ff: int, *,
                   dtype=torch.float32) -> dict:
    """Non-gated 2-layer MLP with biases (seamless / classic
    transformer)."""
    return {"wi": fanin_init(gen, (d, d_ff), dtype=dtype),
            "wo": fanin_init(gen, (d_ff, d), dtype=dtype),
            "bi": zeros_init((d_ff,), dtype=dtype, device=gen.device),
            "bo": zeros_init((d,), dtype=dtype, device=gen.device)}


def apply_plain_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = act_fn(act)(x @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype) + p["bo"].to(x.dtype)


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


# --------------------------------------------------------------------------
# Causal temporal conv (RG-LRU and xLSTM blocks)
# --------------------------------------------------------------------------
def init_conv1d(width: int, d: int, *, dtype=torch.float32,
                device=None) -> dict:
    return {"w": zeros_init((width, d), dtype=dtype, device=device),
            "b": zeros_init((d,), dtype=dtype, device=device)}


def apply_conv1d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time, x: (B, S, D): tap ``width-1-i``
    reads the input ``i`` steps back (zeros before the start)."""
    w = p["w"].to(x.dtype)
    S = x.shape[1]
    out = x * w[-1]
    for i in range(1, w.shape[0]):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out + p["b"].to(x.dtype)


def conv1d_step(p: dict, buf: torch.Tensor, x_t: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  buf: (B, width-1, D) past inputs; x_t: (B, D)
    -> (y (B, D), the next buffer)."""
    w = p["w"].to(x_t.dtype)
    window = torch.cat([buf.to(x_t.dtype), x_t[:, None]], dim=1)
    y = torch.einsum("bwd,wd->bd", window, w) + p["b"].to(x_t.dtype)
    return y, window[:, 1:]
