"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

The port of ``repro/models/xlstm.py``, with its numerics: f32 gates, the
stabiliser ``m`` starting at -1e30, log-sigmoid forget gates and the
mLSTM denominator ``max(|n . q|, exp(-m))``.

mLSTM cell (per head, head dims d_k = d_v = d_inner / H), stabilised by
m_t = max(log f_t + m_{t-1}, log i_t):

    C_t = f' C_{t-1} + i' v_t k_t^T,   n_t = f' n_{t-1} + i' k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

with i' = exp(log i_t - m_t), f' = exp(log f_t + m_{t-1} - m_t).  Prefill
uses the parallel form (a masked S x S gate matrix built from cumulative
log-f gates); decode steps the recurrence with (C, n, m) in the cache.
The reference's prefill cache (``transformer._mlstm_prefill_cache``)
scans the prompt once more, one rank-1 update a token.  Here the cache
is the recurrence's closed form, read off the quantities the parallel
form already has: with F_t the cumulative log-f,

    m_S = max_s (F_S - F_s + log i_s)
    C_S = sum_s exp(F_S - F_s + log i_s - m_S) v_s k_s^T   (n_S: k_s)

one batched product a layer instead of one step a token (the initial
``-1e30 + F_S`` term of the recurrence's maximum never wins).

sLSTM is sequential (h_{t-1} feeds the gates), so prefill loops over
time.  The four input projections of every token are one product before
the loop and the four per-head recurrent products one ``baddbmm`` a
step, so a token costs some 17 launches a layer.

Block wiring follows the paper: mLSTM block = up-projection (factor 2,
x and gate paths) -> causal conv4 feeding q/k -> cell -> GroupNorm ->
gated by silu(gate path) -> down-projection; sLSTM block = conv4 -> cell
-> GroupNorm -> out-projection.  No Pallas kernel computes either in the
reference (XLA code), so both are plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

NEG_INIT = -1e30     # the stabiliser m before the first token


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm_block(gen: torch.Generator, d: int, n_heads: int,
                     proj_factor: float, conv_width: int, *,
                     dtype=torch.float32) -> dict:
    di = int(d * proj_factor)
    dev = gen.device
    return {
        "up_x": L.fanin_init(gen, (d, di), dtype=dtype),
        "up_g": L.fanin_init(gen, (d, di), dtype=dtype),
        "conv": L.init_conv1d(conv_width, di, dtype=dtype, device=dev),
        "wq": L.fanin_init(gen, (di, di), dtype=dtype),
        "wk": L.fanin_init(gen, (di, di), dtype=dtype),
        "wv": L.fanin_init(gen, (di, di), dtype=dtype),
        "wi": L.fanin_init(gen, (di, n_heads), dtype=dtype),
        "bi": L.zeros_init((n_heads,), dtype=dtype, device=dev),
        "wf": L.fanin_init(gen, (di, n_heads), dtype=dtype),
        "bf": torch.linspace(3.0, 6.0, n_heads, device=dev).to(dtype),
        "gn": torch.ones((di,), dtype=dtype, device=dev),
        "down": L.fanin_init(gen, (di, d), dtype=dtype),
    }


def _mlstm_qkvif(p, x):
    """x: (B, S, di) -> q, k, v (B, S, di), log i / log f (B, S, H) f32."""
    conv_x = F.silu(L.apply_conv1d(p["conv"], x).float()).to(x.dtype)
    q = conv_x @ p["wq"].to(x.dtype)
    k = conv_x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    xf = x.float()
    log_i = xf @ p["wi"].float() + p["bi"].float()
    log_f = F.logsigmoid(xf @ p["wf"].float() + p["bf"].float())
    return q, k, v, log_i, log_f


def _heads(x, n_heads):
    """(B, S, di) -> (B, H, S, dh)."""
    B, S, di = x.shape
    return x.reshape(B, S, n_heads, di // n_heads).transpose(1, 2)


def _log_gates(log_i, log_f):
    """-> (F (B, H, S) cumulative log-f, logD (B, H, S, S) the masked log
    gate matrix F_t - F_s + log i_s for s <= t, -inf above)."""
    li = log_i.transpose(1, 2)                                  # B,H,S
    Fc = torch.cumsum(log_f.transpose(1, 2), dim=-1)            # log prod f
    logD = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    S = Fc.shape[-1]
    mask = torch.ones((S, S), dtype=torch.bool, device=Fc.device).tril()
    return Fc, torch.where(mask, logD, float("-inf"))


def mlstm_parallel(q, k, v, log_i, log_f, n_heads: int):
    """Stabilised parallel form.  q/k/v: (B, S, di); gates (B, S, H) ->
    (h (B, S, di) f32, (m (B, H, S), F (B, H, S)))."""
    B, S, di = q.shape
    scale = (di // n_heads) ** -0.5
    qh, kh, vh = (_heads(a, n_heads) for a in (q, k, v))
    Fc, logD = _log_gates(log_i, log_f)
    m = logD.amax(dim=-1)                                       # (B,H,S)
    D = torch.exp(logD - m[..., None])                          # (B,H,S,S)
    logits = (qh @ kh.transpose(-1, -2)).float() * scale
    w = logits * D
    n = torch.maximum(w.sum(dim=-1).abs(), torch.exp(-m))       # |sum w|
    h = ((w / n[..., None]).to(vh.dtype) @ vh).float()
    return h.transpose(1, 2).reshape(B, S, di), (m, Fc)


def mlstm_final_state(k, v, log_i, log_f, n_heads: int) -> dict:
    """The recurrence's state after the last token, in closed form (see
    the module docstring): {C (B, H, dh, dh), n (B, H, dh), m (B, H)},
    all f32, what ``mlstm_step`` carries."""
    kh = _heads(k, n_heads).float()                             # B,H,S,dh
    vh = _heads(v, n_heads).float()
    Fc = torch.cumsum(log_f.transpose(1, 2), dim=-1)            # (B,H,S)
    last = Fc[..., -1:] - Fc + log_i.transpose(1, 2)            # row S - 1
    m = last.amax(dim=-1)                                       # (B,H)
    wgt = torch.exp(last - m[..., None])                        # (B,H,S)
    C = (vh * wgt[..., None]).transpose(-1, -2) @ kh            # B,H,dv,dk
    n = (wgt[..., None] * kh).sum(dim=-2)                       # (B,H,dk)
    return {"C": C, "n": n, "m": m}


def mlstm_step(q_t, k_t, v_t, log_i_t, log_f_t, cache, n_heads: int):
    """One decode step.  q/k/v_t: (B, di); gates (B, H); cache = {C (B,
    H, dh, dh), n (B, H, dh), m (B, H)}, f32.  -> (h (B, di) f32, the
    new {C, n, m})."""
    B, di = q_t.shape
    H = n_heads
    dh = di // H
    qh = q_t.reshape(B, H, dh).float() * dh ** -0.5
    kh = k_t.reshape(B, H, dh).float()
    vh = v_t.reshape(B, H, dh).float()
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(log_f_t + m, log_i_t)                 # (B,H)
    i_p = torch.exp(log_i_t - m_new)
    f_p = torch.exp(log_f_t + m - m_new)
    C_new = f_p[..., None, None] * C \
        + i_p[..., None, None] * vh[..., :, None] * kh[..., None, :]
    n_new = f_p[..., None] * n + i_p[..., None] * kh
    num = (C_new @ qh[..., None])[..., 0]                       # (B,H,dv)
    den = torch.maximum((n_new * qh).sum(dim=-1).abs(), torch.exp(-m_new))
    h = num / den[..., None]
    return h.reshape(B, di), {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_out(p, h, g, n_heads, dtype):
    """GroupNorm, the silu gate and the down-projection."""
    h = L.group_norm(h.to(dtype), n_heads, p["gn"])
    h = h * F.silu(g.float()).to(dtype)
    return h @ p["down"].to(dtype)


def apply_mlstm_block(p: dict, x: torch.Tensor, n_heads: int):
    """Prefill.  x: (B, S, D) (already normed) -> (y (B, S, D), the
    decode cache {C, n, m, conv}), the cache the reference's
    ``transformer._mlstm_prefill_cache`` computes."""
    xi = x @ p["up_x"].to(x.dtype)
    g = x @ p["up_g"].to(x.dtype)
    q, k, v, li, lf = _mlstm_qkvif(p, xi)
    h, _ = mlstm_parallel(q, k, v, li, lf, n_heads)
    y = _mlstm_out(p, h, g, n_heads, x.dtype)
    width = p["conv"]["w"].shape[0]
    return y, {**mlstm_final_state(k, v, li, lf, n_heads),
               "conv": xi[:, -(width - 1):]}


def apply_mlstm_block_step(p: dict, x_t: torch.Tensor, cache: dict,
                           n_heads: int):
    """Decode.  x_t: (B, 1, D); the cache also holds the conv buffer."""
    xt = x_t[:, 0]
    xi = xt @ p["up_x"].to(xt.dtype)
    g = xt @ p["up_g"].to(xt.dtype)
    conv_y, conv_buf = L.conv1d_step(p["conv"], cache["conv"], xi)
    conv_y = F.silu(conv_y.float()).to(xt.dtype)
    q = conv_y @ p["wq"].to(xt.dtype)
    k = conv_y @ p["wk"].to(xt.dtype)
    v = xi @ p["wv"].to(xt.dtype)
    xif = xi.float()
    li = xif @ p["wi"].float() + p["bi"].float()
    lf = F.logsigmoid(xif @ p["wf"].float() + p["bf"].float())
    h, cell = mlstm_step(q, k, v, li, lf, cache, n_heads)
    y = _mlstm_out(p, h, g, n_heads, xt.dtype)
    return y[:, None], {**cell, "conv": conv_buf}


def init_mlstm_cache(batch: int, d: int, n_heads: int, proj_factor: float,
                     conv_width: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    di = int(d * proj_factor)
    dh = di // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, dh, dh), **f32),
            "n": torch.zeros((batch, n_heads, dh), **f32),
            "m": torch.full((batch, n_heads), NEG_INIT, **f32),
            "conv": torch.zeros((batch, conv_width - 1, di), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
GATES = ("z", "i", "f", "o")


def init_slstm_block(gen: torch.Generator, d: int, n_heads: int,
                     conv_width: int, *, dtype=torch.float32) -> dict:
    dh = d // n_heads
    dev = gen.device
    p = {"conv": L.init_conv1d(conv_width, d, dtype=dtype, device=dev),
         "gn": torch.ones((d,), dtype=dtype, device=dev)}
    for name in GATES:
        p[f"w_{name}"] = L.fanin_init(gen, (d, d), dtype=dtype)
        p[f"b_{name}"] = L.zeros_init((d,), dtype=dtype, device=dev)
    for name in GATES:   # block-diagonal recurrent weights, (dh, dh) a head
        p[f"r_{name}"] = L.normal_init(gen, (n_heads, dh, dh),
                                       std=dh ** -0.5, dtype=dtype)
    p["b_f_init"] = torch.linspace(3.0, 6.0, d, device=dev).to(dtype)
    p["out"] = L.fanin_init(gen, (d, d), dtype=dtype)
    return p


def _slstm_inputs(p, x):
    """The input side of every gate for every token, in the layout the
    scan reads: x: (B, S, d) conv output -> (S, H, B, 4 dh) f32, gate
    g of head h at columns g dh .. g dh + dh - 1 (order z, i, f, o)."""
    B, S, d = x.shape
    H = p["r_z"].shape[0]
    w = torch.stack([p[f"w_{g}"].float() for g in GATES], 1)    # (d, 4, d)
    b = torch.stack([p[f"b_{g}"].float() for g in GATES])       # (4, d)
    pre = (x.float() @ w.reshape(d, 4 * d)).reshape(B, S, 4, d) + b
    pre[:, :, 2] += p["b_f_init"].float()
    return pre.reshape(B, S, 4, H, d // H).permute(1, 3, 0, 2, 4) \
        .reshape(S, H, B, 4 * (d // H))


def _slstm_recurrent(p):
    """The four per-head recurrent matrices side by side: (H, dh, 4 dh)."""
    r = torch.stack([p[f"r_{g}"].float() for g in GATES], 2)    # H,dh,4,dh
    return r.reshape(r.shape[0], r.shape[1], -1)


def _to_heads(x, H):
    """(B, d) -> (H, B, dh)."""
    B, d = x.shape
    return x.reshape(B, H, d // H).transpose(0, 1)


def _from_heads(x):
    """(H, B, dh) -> (B, d)."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def slstm_scan(p, x, state, n_heads: int):
    """The cell over every token of x: (B, S, d) conv output; state = (c,
    n, m, h) each (B, d) f32.  -> (hs (B, S, d) f32, the final state)."""
    B, S, d = x.shape
    pre = _slstm_inputs(p, x)
    rec = _slstm_recurrent(p)
    c, n, m, h = (_to_heads(s, n_heads) for s in state)
    hs = torch.empty((S, n_heads, B, d // n_heads), dtype=torch.float32,
                     device=x.device)
    for t in range(S):
        a = torch.baddbmm(pre[t], h, rec).unflatten(-1, (4, -1))
        z = torch.tanh(a[..., 0, :])
        li = a[..., 1, :]
        lf = F.logsigmoid(a[..., 2, :])
        lfm = lf + m
        m_new = torch.maximum(lfm, li)
        i_p = torch.exp(li - m_new)
        f_p = torch.exp(lfm - m_new)
        c = torch.addcmul(f_p * c, i_p, z)
        n = f_p * n + i_p
        m = m_new
        h = torch.div(torch.sigmoid(a[..., 3, :]) * c,
                      torch.clamp(n, min=1.0), out=hs[t])
    return (hs.permute(2, 0, 1, 3).reshape(B, S, d),
            tuple(_from_heads(s) for s in (c, n, m, h)))


def slstm_cell(p, x_t, state, n_heads: int):
    """x_t: (B, d) conv output; state = (c, n, m, h) each (B, d) f32 ->
    the next (c, n, m, h)."""
    return slstm_scan(p, x_t[:, None], state, n_heads)[1]


def apply_slstm_block(p: dict, x: torch.Tensor, n_heads: int,
                      state: tuple | None = None):
    """Prefill: the sequential scan over S.  x: (B, S, D) -> (y (B, S,
    D), the final state)."""
    B, S, d = x.shape
    xc = F.silu(L.apply_conv1d(p["conv"], x).float()).to(x.dtype)
    if state is None:
        state = init_slstm_state(B, d, device=x.device)
    hs, state = slstm_scan(p, xc, state, n_heads)
    hs = L.group_norm(hs.to(x.dtype), n_heads, p["gn"])
    return hs @ p["out"].to(x.dtype), state


def apply_slstm_block_step(p: dict, x_t: torch.Tensor, cache: dict,
                           n_heads: int):
    xt = x_t[:, 0]
    conv_y, conv_buf = L.conv1d_step(p["conv"], cache["conv"], xt)
    conv_y = F.silu(conv_y.float()).to(xt.dtype)
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, h = slstm_cell(p, conv_y, state, n_heads)
    y = L.group_norm(h.to(xt.dtype), n_heads, p["gn"])
    y = y @ p["out"].to(xt.dtype)
    return y[:, None], {"c": c, "n": n, "m": m, "h": h, "conv": conv_buf}


def init_slstm_state(batch: int, d: int, device=None):
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (z, z, torch.full((batch, d), NEG_INIT, dtype=torch.float32,
                             device=device), z)


def init_slstm_cache(batch: int, d: int, conv_width: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    c, n, m, h = init_slstm_state(batch, d, device=device)
    return {"c": c, "n": n, "m": m, "h": h,
            "conv": torch.zeros((batch, conv_width - 1, d), dtype=dtype,
                                device=device)}
