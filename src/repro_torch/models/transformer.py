"""Attention sub-layers and the transformer, recurrent and xLSTM blocks.

The serving half of ``repro/models/transformer.py``: every block kind of
the reference, ``global`` (attention + MLP), ``local`` (sliding-window
attention + gated MLP, a ring cache of ``min(window, cache_len)``
slots), ``dense_ffn`` (attention + a wider gated MLP, deepseek's layer
0), ``moe`` (attention + routed experts), ``rec`` (the RG-LRU block +
gated MLP), ``mlstm`` and ``slstm`` (the xLSTM blocks, no separate FFN),
with QK-norm, the sandwich post-norms ``ln1b``/``ln2b``, gemma3's local
RoPE theta, command-r's parallel blocks (attention and FFN both read
``ln1``'s output), encoder-decoder cross-attention and the plain MLP.
Each block has a fused prefill path and a one-token decode path with an
explicit cache entry:

  kind                   cache entry
  global/moe/dense_ffn   {k, v: (B, S_cache, KV, hd), slot_pos: (B, S_cache)}
  local                  the same fields over min(window, S_cache) slots
  rec                    {h: (B, d_rnn) f32, conv: (B, width-1, d_rnn)}
  mlstm                  {C, n, m (f32), conv: (B, width-1, d_inner)}
  slstm                  {c, n, m, h (B, d) f32, conv: (B, width-1, d)}
  cross-attention        + {ck, cv: (B, S_enc, KV, hd)} (written at prefill)

Prefill attention calls the flash-attention kernel's wrapper
(``attention.flash``) on (B*H, S, hd) views, after repeating the KV
heads to full heads: causal for decoder blocks, causal with ``window``
for local ones (``attention.sliding_window_attention``, the reference's
route for local prefill), non-causal for an encoder.  For global blocks
that is the kernel route the reference documents for
``attn_impl="pallas"`` (its own dispatch falls through to the XLA
``flash_chunked`` there, ROADMAP queue C); ``"chunked"`` and
``"pallas"`` both take it, ``"hier"`` and ``"block"`` take
``hierarchical_causal`` and ``block_causal`` where the reference does.
Cross-attention, at prefill and at decode, is the kernel's non-causal
call against the encoder's keys, the reference's ``flash_chunked`` with
``causal=False``.  Decode self-attention goes through
``attention.decode_update_attend``.

``mode`` is ``"prefill"`` (builds the decode cache), ``"decode"`` or
``"train"``: the forward pass with no cache, the reference's name for
it, which its ``loss_fn`` runs and its ``prefill`` runs over an encoder.
In ``"train"`` mode on the card the flash call is differentiable
(``kernels/flash_attention.FlashAttention``: the kernel's forward with
its row statistics, the backward kernels); the grouped matmul is not yet
and raises under grad on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Runtime (non-architecture) options, the reference's fields."""
    attn_impl: str = "chunked"       # chunked | pallas | hier | block
    kv_chunk: int = 1024
    remat: bool = True               # recompute each cycle in the backward
    dtype: Any = torch.bfloat16
    loss_chunk: int = 512            # CE loss sequence chunking


ATTN_KINDS = ("global", "local", "moe", "dense_ffn")
ATTN_IMPLS = ("chunked", "pallas", "hier", "block")
MODES = ("prefill", "decode", "train")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")


def _rope_theta(cfg: ArchConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ArchConfig, *,
                   cross: bool = False, dtype=torch.float32) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p = {
        "wq": L.fanin_init(gen, (d, H, hd), fan_in=d, dtype=dtype),
        "wk": L.fanin_init(gen, (d, KV, hd), fan_in=d, dtype=dtype),
        "wv": L.fanin_init(gen, (d, KV, hd), fan_in=d, dtype=dtype),
        "wo": L.fanin_init(gen, (H, hd, d), fan_in=H * hd, dtype=dtype),
    }
    if cfg.attn_bias:
        p["bq"] = L.zeros_init((H, hd), dtype=dtype, device=dev)
        p["bk"] = L.zeros_init((KV, hd), dtype=dtype, device=dev)
        p["bv"] = L.zeros_init((KV, hd), dtype=dtype, device=dev)
    if cfg.qk_norm and not cross:
        p["qn"] = L.zeros_init((hd,), dtype=dtype, device=dev)
        p["kn"] = L.zeros_init((hd,), dtype=dtype, device=dev)
    return p


def _proj(x, w):
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd)."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _project_qkv(p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if "qn" in p:
        q = L.rms_norm_headwise(p["qn"], q)
        k = L.rms_norm_headwise(p["kn"], k)
    return q, k, v


def _out_proj(p, o, dtype):
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d)."""
    return (o.flatten(2).to(dtype) @ p["wo"].to(dtype).flatten(0, 1))


def apply_attention(p, x, cfg: ArchConfig, opt: ModelOptions, kind: str,
                    positions, *, causal: bool = True, cache=None,
                    mode: str = "prefill", cache_len: int | None = None):
    """Full attention sub-layer.  Returns (y, new_cache); the cache is
    None in ``"train"`` mode."""
    _check_mode(mode)
    theta = _rope_theta(cfg, kind)
    window = cfg.window if kind == "local" else 0

    if mode == "decode":
        q, k_new, v_new = _project_qkv(p, x)            # (B,1,H/KV,hd)
        pos = positions[:, 0]                           # (B,)
        q = L.apply_rope(q, positions, theta)
        k_new = L.apply_rope(k_new, positions, theta)
        o, k, v, slot_pos = ATT.decode_update_attend(
            q, k_new, v_new, cache["k"], cache["v"], cache["slot_pos"],
            pos, window=window, softcap=cfg.attn_softcap,
            chunk=opt.kv_chunk)
        return _out_proj(p, o, x.dtype), {"k": k, "v": v,
                                          "slot_pos": slot_pos}

    if opt.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {opt.attn_impl!r}")
    q, k, v = _project_qkv(p, x)
    q = L.apply_rope(q, positions, theta)
    k = L.apply_rope(k, positions, theta)
    S, c = q.shape[1], opt.kv_chunk
    softcap = cfg.attn_softcap
    if kind == "local" and causal:
        o = ATT.sliding_window_attention(q, k, v, positions, window=window,
                                         softcap=softcap)
    elif causal and opt.attn_impl == "hier" and S > c:
        o = ATT.hierarchical_causal(q, k, v, softcap=softcap, base_chunk=c)
    elif causal and opt.attn_impl == "block" and S % c == 0 and S > c:
        o = ATT.block_causal(q, k, v, softcap=softcap, chunk=c)
    else:
        o = ATT.flash(q, k, v, causal=causal, window=window,
                      softcap=softcap)
    y = _out_proj(p, o, x.dtype)
    if mode == "train":
        return y, None

    # the decode cache: positions max(0, S-ring)..S-1 at slot (pos % ring)
    # (a local layer keeps a ring of min(window, cache_len) slots); the
    # cache holds the KV heads unrepeated
    B, S, KVh, hd = k.shape
    cl = max(cache_len or S, S)
    ring = min(window, cl) if window else cl
    n_keep = min(ring, S)
    pos_keep = torch.arange(S - n_keep, S, device=x.device)
    slots = pos_keep % ring
    kbuf = torch.zeros((B, ring, KVh, hd), dtype=k.dtype, device=x.device)
    vbuf = torch.zeros_like(kbuf)
    spbuf = torch.full((B, ring), -1, dtype=torch.int32, device=x.device)
    kbuf[:, slots] = k[:, pos_keep]
    vbuf[:, slots] = v[:, pos_keep]
    spbuf[:, slots] = pos_keep.to(torch.int32)
    return y, {"k": kbuf, "v": vbuf, "slot_pos": spbuf}


def apply_cross_attention(p, x, memory_kv, cfg: ArchConfig,
                          opt: ModelOptions, *, mode: str = "prefill"):
    """Attention of x (B, S, d) over the encoder memory's precomputed
    ``memory_kv = (k, v)`` (B, S_enc, KV, hd): no RoPE, no mask, one
    non-causal flash call (``S = 1`` at decode)."""
    del opt, mode
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    mk, mv = memory_kv
    o = ATT.flash(q, mk, mv, causal=False)
    return _out_proj(p, o, x.dtype)


def project_memory_kv(p, memory, cfg: ArchConfig):
    """Cross-attention K/V from the encoder memory (no RoPE)."""
    del cfg
    k, v = _proj(memory, p["wk"]), _proj(memory, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return k, v


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, kind: str, cfg: ArchConfig, *,
               with_cross: bool = False, dtype=torch.float32) -> dict:
    dev = gen.device

    def nrm():
        return L.init_norm(cfg.norm, cfg.d_model, dtype=dtype, device=dev)

    def gated(d_ff):
        return L.init_gated_mlp(gen, cfg.d_model, d_ff, dtype=dtype)

    if kind in ATTN_KINDS:
        p: dict = {"ln1": nrm(), "attn": init_attention(gen, cfg,
                                                        dtype=dtype)}
        if cfg.post_norms:
            p["ln1b"] = nrm()
            p["ln2b"] = nrm()
        if not cfg.parallel_block:
            p["ln2"] = nrm()
        if kind == "moe":
            p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.moe, dtype=dtype)
        elif kind == "dense_ffn":
            p["mlp"] = gated(cfg.d_ff_dense)
        elif cfg.mlp_act in ("silu", "gelu") and not cfg.is_encdec:
            p["mlp"] = gated(cfg.d_ff)
        else:           # an encoder-decoder takes the plain MLP, gelu too
            p["mlp"] = L.init_plain_mlp(gen, cfg.d_model, cfg.d_ff,
                                        dtype=dtype)
        if with_cross:
            p["ln_cross"] = nrm()
            p["cross"] = init_attention(gen, cfg, cross=True, dtype=dtype)
        return p
    if kind == "rec":
        return {"ln1": nrm(),
                "rec": RG.init_rglru_block(gen, cfg.d_model, cfg.d_rnn,
                                           cfg.conv_width, dtype=dtype),
                "ln2": nrm(), "mlp": gated(cfg.d_ff)}
    if kind == "mlstm":
        return {"ln1": nrm(),
                "cell": XL.init_mlstm_block(gen, cfg.d_model, cfg.n_heads,
                                            cfg.mlstm_proj_factor,
                                            cfg.conv_width, dtype=dtype)}
    if kind == "slstm":
        return {"ln1": nrm(),
                "cell": XL.init_slstm_block(gen, cfg.d_model, cfg.n_heads,
                                            cfg.conv_width, dtype=dtype)}
    raise ValueError(f"unknown block kind {kind}")


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, s_cache: int,
                     dtype, *, with_cross: bool = False, s_enc: int = 0,
                     device=None) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.hd
    if kind in ATTN_KINDS:
        size = min(cfg.window, s_cache) if kind == "local" else s_cache
        c = {"k": torch.zeros((batch, size, KV, hd), dtype=dtype,
                              device=device),
             "v": torch.zeros((batch, size, KV, hd), dtype=dtype,
                              device=device),
             "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                                    device=device)}
        if with_cross:
            c["ck"] = torch.zeros((batch, s_enc, KV, hd), dtype=dtype,
                                  device=device)
            c["cv"] = torch.zeros_like(c["ck"])
        return c
    if kind == "rec":
        return RG.init_rglru_cache(batch, cfg.d_rnn, cfg.conv_width, dtype,
                                   device=device)
    if kind == "mlstm":
        return XL.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                   cfg.mlstm_proj_factor, cfg.conv_width,
                                   dtype, device=device)
    if kind == "slstm":
        return XL.init_slstm_cache(batch, cfg.d_model, cfg.conv_width,
                                   dtype, device=device)
    raise ValueError(f"unknown block kind {kind}")


def apply_block(kind: str, p: dict, x, cfg: ArchConfig, opt: ModelOptions,
                positions, *, mode: str, cache=None, memory=None,
                causal: bool = True, with_cross: bool = False,
                cache_len: int | None = None):
    """Returns (x, new_cache, aux_loss); the cache is None in ``"train"``
    mode."""
    _check_mode(mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def nrm(pp, xx):
        return L.apply_norm(cfg.norm, pp, xx, cfg.norm_eps)

    h = nrm(p["ln1"], x)
    if kind in ATTN_KINDS:
        attn_out, new_cache = apply_attention(
            p["attn"], h, cfg, opt, kind, positions, causal=causal,
            cache=cache, mode=mode, cache_len=cache_len)
        if cfg.post_norms:
            attn_out = nrm(p["ln1b"], attn_out)
        if cfg.parallel_block:
            mlp_out, aux = _apply_ffn(kind, p, h, cfg)
            return x + attn_out + mlp_out, new_cache, aux
        x = x + attn_out
        if with_cross:                                  # enc-dec cross-attn
            if mode == "decode":
                mkv = (cache["ck"], cache["cv"])
            else:
                mkv = project_memory_kv(p["cross"], memory, cfg)
            x = x + apply_cross_attention(p["cross"], nrm(p["ln_cross"], x),
                                          mkv, cfg, opt, mode=mode)
            if new_cache is not None:
                new_cache["ck"], new_cache["cv"] = mkv
        mlp_out, aux = _apply_ffn(kind, p, nrm(p["ln2"], x), cfg)
        if cfg.post_norms:
            mlp_out = nrm(p["ln2b"], mlp_out)
        return x + mlp_out, new_cache, aux

    if kind == "rec":
        if mode == "decode":
            y, new_cache = RG.apply_rglru_block_step(p["rec"], h, cache,
                                                     cfg.mlp_act)
        else:
            y, h_last = RG.apply_rglru_block(p["rec"], h, cfg.mlp_act)
            # the conv buffer holds the last width-1 pre-conv inputs:
            # project only those rows
            new_cache = {"h": h_last, "conv": L.apply_linear(
                {"w": p["rec"]["in_rec"]}, h[:, -(cfg.conv_width - 1):])}
        x = x + y
        x = x + L.apply_gated_mlp(p["mlp"], nrm(p["ln2"], x), cfg.mlp_act)
        return x, _keep(new_cache, mode), aux

    if kind == "mlstm":
        if mode == "decode":
            y, new_cache = XL.apply_mlstm_block_step(p["cell"], h, cache,
                                                     cfg.n_heads)
        else:
            y, new_cache = XL.apply_mlstm_block(p["cell"], h, cfg.n_heads)
        return x + y, _keep(new_cache, mode), aux

    if kind == "slstm":
        if mode == "decode":
            y, new_cache = XL.apply_slstm_block_step(p["cell"], h, cache,
                                                     cfg.n_heads)
        else:
            y, state = XL.apply_slstm_block(p["cell"], h, cfg.n_heads)
            new_cache = {"c": state[0], "n": state[1], "m": state[2],
                         "h": state[3], "conv": h[:, -(cfg.conv_width - 1):]}
        return x + y, _keep(new_cache, mode), aux
    raise ValueError(f"unknown block kind {kind}")


def _keep(cache, mode):
    """A recurrent block's cache, dropped in ``"train"`` mode."""
    return None if mode == "train" else cache


def _apply_ffn(kind, p, h, cfg):
    """-> (y, aux_loss); aux is 0 but for MoE blocks."""
    if kind == "moe":
        norm_topk = cfg.moe.n_shared == 0      # qwen3 normalizes, deepseek no
        return MOE.apply_moe(p["moe"], h, cfg.moe, cfg.mlp_act,
                             norm_topk=norm_topk)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if p["mlp"]["wi"].dim() == 3:
        return L.apply_gated_mlp(p["mlp"], h, cfg.mlp_act), zero
    return L.apply_plain_mlp(p["mlp"], h, cfg.mlp_act), zero
