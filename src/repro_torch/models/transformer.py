"""Attention sub-layer and the transformer and recurrent blocks.

The subset of ``repro/models/transformer.py`` that the serving slices
run: block kinds ``global`` (attention + gated MLP), ``local``
(sliding-window attention + gated MLP, a ring cache of
``min(window, cache_len)`` slots), ``dense_ffn`` (attention + a wider
gated MLP, deepseek's layer 0), ``moe`` (attention + routed experts) and
``rec`` (the RG-LRU recurrent block + gated MLP), with QK-norm, the
sandwich post-norms ``ln1b``/``ln2b`` and gemma3's local RoPE theta.
Each block has a fused prefill path and a one-token decode path with an
explicit cache entry:

  kind                   cache entry
  global/moe/dense_ffn   {k, v: (B, S_cache, KV, hd), slot_pos: (B, S_cache)}
  local                  the same fields over min(window, S_cache) slots
  rec                    {h: (B, d_rnn) f32, conv: (B, width-1, d_rnn)}

Prefill attention always calls the flash-attention kernel's wrapper on
(B*H, S, hd) views, after repeating the KV heads to full heads: causal
for global blocks, causal with ``window`` for local ones
(``attention.sliding_window_attention``, the reference's route for
local prefill).  For global blocks that is the kernel route the
reference documents for ``attn_impl="pallas"`` (its own dispatch falls
through to the XLA ``flash_chunked`` there, ROADMAP queue C);
``"chunked"`` and ``"pallas"`` both take it.  Decode attention goes
through ``attention.decode_update_attend``.  The kinds and options this
slice does not run (xLSTM blocks, parallel blocks, cross-attention)
raise ``NotImplementedError`` naming their ROADMAP item.
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


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Runtime (non-architecture) options.  The reference's ``remat`` and
    ``loss_chunk`` are training options and wait for the training
    slice."""
    attn_impl: str = "chunked"       # chunked | pallas (hier, block: later)
    kv_chunk: int = 1024
    dtype: Any = torch.bfloat16


ATTN_KINDS = ("global", "local", "moe", "dense_ffn")
KINDS = ATTN_KINDS + ("rec",)


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise not_ported(f"block kind {kind!r}", "queue A16: xlstm blocks")


def _rope_theta(cfg: ArchConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ArchConfig, *,
                   dtype=torch.float32) -> dict:
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
    if cfg.qk_norm:
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
    """Full attention sub-layer.  Returns (y, new_cache)."""
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

    if mode != "prefill":
        raise not_ported(f"mode {mode!r}", "queue A16: loss_fn and training")
    if opt.attn_impl in ("hier", "block"):
        raise not_ported(f"attn_impl={opt.attn_impl!r}",
                         "queue A16: hierarchical_causal/block_causal")
    if opt.attn_impl not in ("chunked", "pallas"):
        raise ValueError(f"unknown attn_impl {opt.attn_impl!r}")
    if not causal:
        raise not_ported("non-causal self-attention",
                         "queue A16: encoder-decoder")
    q, k, v = _project_qkv(p, x)
    q = L.apply_rope(q, positions, theta)
    k = L.apply_rope(k, positions, theta)
    if kind == "local":
        o = ATT.sliding_window_attention(q, k, v, positions, window=window,
                                         softcap=cfg.attn_softcap)
    else:
        o = ATT.causal_flash(q, k, v, softcap=cfg.attn_softcap)
    y = _out_proj(p, o, x.dtype)

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


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, kind: str, cfg: ArchConfig, *,
               dtype=torch.float32) -> dict:
    _check_kind(kind)
    if cfg.parallel_block or cfg.is_encdec:
        raise not_ported("parallel and cross-attention blocks",
                         "queue A16: remaining configs")
    dev = gen.device

    def nrm():
        return L.init_norm(cfg.norm, cfg.d_model, dtype=dtype, device=dev)

    def gated(d_ff):
        return L.init_gated_mlp(gen, cfg.d_model, d_ff, dtype=dtype)

    if kind == "rec":
        return {"ln1": nrm(),
                "rec": RG.init_rglru_block(gen, cfg.d_model, cfg.d_rnn,
                                           cfg.conv_width, dtype=dtype),
                "ln2": nrm(), "mlp": gated(cfg.d_ff)}
    p: dict = {"ln1": nrm(), "attn": init_attention(gen, cfg, dtype=dtype)}
    if cfg.post_norms:
        p["ln1b"] = nrm()
        p["ln2b"] = nrm()
    p["ln2"] = nrm()
    if kind == "moe":
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.moe, dtype=dtype)
    elif kind == "dense_ffn":
        p["mlp"] = gated(cfg.d_ff_dense)
    elif cfg.mlp_act in ("silu", "gelu"):
        p["mlp"] = gated(cfg.d_ff)
    else:
        raise not_ported(f"plain MLP ({cfg.mlp_act})",
                         "queue A16: remaining configs")
    return p


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, s_cache: int,
                     dtype, device=None) -> dict:
    _check_kind(kind)
    if kind == "rec":
        return RG.init_rglru_cache(batch, cfg.d_rnn, cfg.conv_width, dtype,
                                   device=device)
    KV, hd = cfg.n_kv_heads, cfg.hd
    size = min(cfg.window, s_cache) if kind == "local" else s_cache
    return {"k": torch.zeros((batch, size, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, size, KV, hd), dtype=dtype,
                             device=device),
            "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                                   device=device)}


def apply_block(kind: str, p: dict, x, cfg: ArchConfig, opt: ModelOptions,
                positions, *, mode: str, cache=None, causal: bool = True,
                cache_len: int | None = None):
    """Returns (x, new_cache, aux_loss)."""
    _check_kind(kind)

    def nrm(pp, xx):
        return L.apply_norm(cfg.norm, pp, xx, cfg.norm_eps)

    h = nrm(p["ln1"], x)
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
        return x, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)
    attn_out, new_cache = apply_attention(
        p["attn"], h, cfg, opt, kind, positions, causal=causal, cache=cache,
        mode=mode, cache_len=cache_len)
    if cfg.post_norms:
        attn_out = nrm(p["ln1b"], attn_out)
    x = x + attn_out
    h2 = nrm(p["ln2"], x)
    mlp_out, aux = _apply_ffn(kind, p, h2, cfg)
    if cfg.post_norms:
        mlp_out = nrm(p["ln2b"], mlp_out)
    return x + mlp_out, new_cache, aux


def _apply_ffn(kind, p, h, cfg):
    """-> (y, aux_loss); aux is 0 but for MoE blocks."""
    if kind == "moe":
        norm_topk = cfg.moe.n_shared == 0      # qwen3 normalizes, deepseek no
        return MOE.apply_moe(p["moe"], h, cfg.moe, cfg.mlp_act,
                             norm_topk=norm_topk)
    return L.apply_gated_mlp(p["mlp"], h, cfg.mlp_act), \
        torch.zeros((), dtype=torch.float32, device=h.device)
