"""Attention sub-layer and the dense and MoE transformer blocks.

The subset of ``repro/models/transformer.py`` that the serving slice
runs: block kinds ``global`` (attention + gated MLP), ``dense_ffn``
(attention + a wider gated MLP, deepseek's layer 0) and ``moe``
(attention + routed experts).  Each block has a fused prefill path and a
one-token decode path with an explicit cache entry
``{k, v: (B, S_cache, KV, hd), slot_pos: (B, S_cache)}``.

Prefill attention of a causal, non-local block always calls the
flash-attention kernel's wrapper on (B*H, S, hd) views, after repeating
the KV heads to full heads; that is the kernel route the reference
documents for ``attn_impl="pallas"`` (its own dispatch falls through to
the XLA ``flash_chunked`` there, ROADMAP queue C).  ``"chunked"`` and
``"pallas"`` both take it.  Decode attention goes through
``attention.decode_update_attend``.  The kinds and options this slice
does not run raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Runtime (non-architecture) options.  The reference's ``remat`` and
    ``loss_chunk`` are training options and wait for the training
    slice."""
    attn_impl: str = "chunked"       # chunked | pallas (hier, block: later)
    kv_chunk: int = 1024
    dtype: Any = torch.bfloat16


ATTN_KINDS = ("global", "moe", "dense_ffn")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_kind(kind: str) -> None:
    if kind == "local":
        raise not_ported("sliding-window ('local') attention",
                         "queue A16: sliding_window_attention")
    if kind not in ATTN_KINDS:
        raise not_ported(f"block kind {kind!r}",
                         "queue A16: rglru/xlstm blocks")


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ArchConfig, *,
                   dtype=torch.float32) -> dict:
    if cfg.qk_norm:
        raise not_ported("QK-norm", "queue A16: qwen3/gemma3 blocks")
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
    return q, k, v


def _out_proj(p, o, dtype):
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d)."""
    return (o.flatten(2).to(dtype) @ p["wo"].to(dtype).flatten(0, 1))


def _heads_to_batch(x):
    """(B, S, H, hd) -> (B*H, S, hd)."""
    B, S, H, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, hd)


def apply_attention(p, x, cfg: ArchConfig, opt: ModelOptions, kind: str,
                    positions, *, causal: bool = True, cache=None,
                    mode: str = "prefill", cache_len: int | None = None):
    """Full attention sub-layer.  Returns (y, new_cache)."""
    _check_kind(kind)
    theta = cfg.rope_theta

    if mode == "decode":
        q, k_new, v_new = _project_qkv(p, x)            # (B,1,H/KV,hd)
        pos = positions[:, 0]                           # (B,)
        q = L.apply_rope(q, positions, theta)
        k_new = L.apply_rope(k_new, positions, theta)
        o, k, v, slot_pos = ATT.decode_update_attend(
            q, k_new, v_new, cache["k"], cache["v"], cache["slot_pos"],
            pos, softcap=cfg.attn_softcap, chunk=opt.kv_chunk)
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
    k_cache, v_cache = k, v                  # GQA layout kept for the cache
    G = cfg.n_heads // cfg.n_kv_heads
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    B, S, H, hd = q.shape
    o = FA.flash_attention(_heads_to_batch(q), _heads_to_batch(k),
                           _heads_to_batch(v), causal=True,
                           softcap=cfg.attn_softcap)
    o = o.reshape(B, H, S, hd).permute(0, 2, 1, 3)
    y = _out_proj(p, o, x.dtype)

    # the decode cache: positions max(0, S-ring)..S-1 at slot (pos % ring)
    ring = max(cache_len or S, S)
    n_keep = min(ring, S)
    pos_keep = torch.arange(S - n_keep, S, device=x.device)
    slots = pos_keep % ring
    KVh = k_cache.shape[2]
    kbuf = torch.zeros((B, ring, KVh, hd), dtype=k_cache.dtype,
                       device=x.device)
    vbuf = torch.zeros_like(kbuf)
    spbuf = torch.full((B, ring), -1, dtype=torch.int32, device=x.device)
    kbuf[:, slots] = k_cache[:, pos_keep]
    vbuf[:, slots] = v_cache[:, pos_keep]
    spbuf[:, slots] = pos_keep.to(torch.int32)
    return y, {"k": kbuf, "v": vbuf, "slot_pos": spbuf}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, kind: str, cfg: ArchConfig, *,
               dtype=torch.float32) -> dict:
    _check_kind(kind)
    if cfg.post_norms or cfg.parallel_block or cfg.is_encdec:
        raise not_ported("post-norm, parallel and cross-attention blocks",
                         "queue A16: remaining configs")
    dev = gen.device

    def nrm():
        return L.init_norm(cfg.norm, cfg.d_model, dtype=dtype, device=dev)

    p: dict = {"ln1": nrm(), "attn": init_attention(gen, cfg, dtype=dtype),
               "ln2": nrm()}
    if kind == "moe":
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.moe, dtype=dtype)
    elif kind == "dense_ffn":
        p["mlp"] = L.init_gated_mlp(gen, cfg.d_model, cfg.d_ff_dense,
                                    dtype=dtype)
    elif cfg.mlp_act in ("silu", "gelu"):
        p["mlp"] = L.init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype)
    else:
        raise not_ported(f"plain MLP ({cfg.mlp_act})",
                         "queue A16: remaining configs")
    return p


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, s_cache: int,
                     dtype, device=None) -> dict:
    _check_kind(kind)
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, s_cache, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, s_cache, KV, hd), dtype=dtype,
                             device=device),
            "slot_pos": torch.full((batch, s_cache), -1, dtype=torch.int32,
                                   device=device)}


def apply_block(kind: str, p: dict, x, cfg: ArchConfig, opt: ModelOptions,
                positions, *, mode: str, cache=None, causal: bool = True,
                cache_len: int | None = None):
    """Returns (x, new_cache, aux_loss)."""
    def nrm(pp, xx):
        return L.apply_norm(cfg.norm, pp, xx, cfg.norm_eps)

    h = nrm(p["ln1"], x)
    attn_out, new_cache = apply_attention(
        p["attn"], h, cfg, opt, kind, positions, causal=causal, cache=cache,
        mode=mode, cache_len=cache_len)
    x = x + attn_out
    h2 = nrm(p["ln2"], x)
    mlp_out, aux = _apply_ffn(kind, p, h2, cfg)
    return x + mlp_out, new_cache, aux


def _apply_ffn(kind, p, h, cfg):
    """-> (y, aux_loss); aux is 0 but for MoE blocks."""
    if kind == "moe":
        norm_topk = cfg.moe.n_shared == 0      # qwen3 normalizes, deepseek no
        return MOE.apply_moe(p["moe"], h, cfg.moe, cfg.mlp_act,
                             norm_topk=norm_topk)
    return L.apply_gated_mlp(p["mlp"], h, cfg.mlp_act), \
        torch.zeros((), dtype=torch.float32, device=h.device)
