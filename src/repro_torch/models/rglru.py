"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of ``repro/models/rglru.py``.  Block structure (the Griffin
"recurrent block"):

    x -> [linear -> temporal conv(4) -> RG-LRU]  (recurrent branch)
      -> [linear -> GeLU]                        (gate branch)
    y = branch_rec * branch_gate -> linear out

RG-LRU cell (per channel):

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(c * r_t * -softplus(Lambda))  in (0, 1), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the linear recurrence h_t = a_t h_{t-1} + b_t as a
log-depth scan over time: ceil(log2 S) rounds of vectorized tensor ops,
each combining every position with the one ``d`` steps back by the
reference's associative combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 +
b2)`` (``jax.lax.associative_scan`` there), so a 2048-token prompt costs
a few dozen launches a layer, not one a position.  Decode carries ``{h:
(B, d_rnn) f32, conv: (B, width-1, d_rnn)}`` in the layer cache.  No
Pallas kernel computes the block in the reference (it is XLA code), so
it is plain PyTorch here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

C_FACTOR = 8.0


def init_rglru_block(gen: torch.Generator, d: int, d_rnn: int,
                     conv_width: int, *, dtype=torch.float32) -> dict:
    """Random weights at the reference's scales, drawn from ``gen``."""
    dev = gen.device
    return {
        "in_rec": L.fanin_init(gen, (d, d_rnn), dtype=dtype),
        "in_gate": L.fanin_init(gen, (d, d_rnn), dtype=dtype),
        "conv": L.init_conv1d(conv_width, d_rnn, dtype=dtype, device=dev),
        "w_a": L.fanin_init(gen, (d_rnn, d_rnn), dtype=dtype),
        "b_a": L.zeros_init((d_rnn,), dtype=dtype, device=dev),
        "w_x": L.fanin_init(gen, (d_rnn, d_rnn), dtype=dtype),
        "b_x": L.zeros_init((d_rnn,), dtype=dtype, device=dev),
        "lam": init_lambda(gen, d_rnn).to(dtype),
        "out": L.fanin_init(gen, (d_rnn, d), dtype=dtype),
    }


def init_lambda(gen: torch.Generator, d_rnn: int) -> torch.Tensor:
    """Lambda such that a^c spreads over (0.9, 0.999) as in the paper:
    softplus(lam) = -log(u) / c, u uniform."""
    u = 0.9 + 0.099 * torch.rand((d_rnn,), generator=gen,
                                 dtype=torch.float32, device=gen.device)
    return torch.log(torch.expm1(-torch.log(u) / C_FACTOR))


def _gates(p: dict, x: torch.Tensor):
    """x: (..., d_rnn) conv output -> (a, b) of the linear recurrence,
    f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"].float())
    log_a = -C_FACTOR * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_0 = 0, as a log-depth
    (Hillis-Steele) scan: round d combines position t with t - d for
    d = 1, 2, 4, ...  -> h (same shape as b)."""
    S = a.shape[1]
    for k in range(math.ceil(math.log2(S)) if S > 1 else 0):
        d = 1 << k
        # combine((a[t-d], b[t-d]), (a[t], b[t])) for t >= d
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b


def rglru_scan(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel form over time.  x: (B, S, d_rnn) -> (y in x's dtype,
    h_last (B, d_rnn) f32)."""
    a, b = _gates(p, x)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    hh = linear_scan(a, b)
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(p: dict, x_t: torch.Tensor, h: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x_t: (B, d_rnn); h: (B, d_rnn) f32."""
    a, b = _gates(p, x_t)
    h_new = a * h.float() + b
    return h_new.to(x_t.dtype), h_new


def apply_rglru_block(p: dict, x: torch.Tensor, act: str = "gelu",
                      h0: torch.Tensor | None = None):
    """Train/prefill.  x: (B, S, D) -> (y, h_last)."""
    rec = L.apply_linear({"w": p["in_rec"]}, x)
    gate = L.apply_linear({"w": p["in_gate"]}, x)
    rec = L.apply_conv1d(p["conv"], rec)
    rec, h_last = rglru_scan(p, rec, h0)
    y = rec * L.act_fn(act)(gate.float()).to(x.dtype)
    return L.apply_linear({"w": p["out"]}, y), h_last


def apply_rglru_block_step(p: dict, x_t: torch.Tensor, cache: dict,
                           act: str = "gelu"):
    """Decode step.  x_t: (B, 1, D); cache ``{"h": (B, d_rnn) f32,
    "conv": (B, width-1, d_rnn)}`` -> (y (B, 1, D), new cache)."""
    xt = x_t[:, 0]
    rec = xt @ p["in_rec"].to(xt.dtype)
    gate = xt @ p["in_gate"].to(xt.dtype)
    rec, conv_buf = L.conv1d_step(p["conv"], cache["conv"], rec)
    rec, h = rglru_step(p, rec, cache["h"])
    y = rec * L.act_fn(act)(gate.float()).to(xt.dtype)
    y = y @ p["out"].to(xt.dtype)
    return y[:, None], {"h": h, "conv": conv_buf}


def init_rglru_cache(batch: int, d_rnn: int, conv_width: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                                device=device)}
