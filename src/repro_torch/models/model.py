"""Language-model assembly: embeddings, the block stack, the loss,
prefill, decode.

``repro/models/model.py`` on one device:

    init_lm(gen, cfg, dtype=)         -> parameter dict
    init_cache(cfg, batch, s_cache)   -> decode cache dict
    loss_fn(params, batch, ...)       -> (loss, metrics)      [train fwd]
    prefill(params, inputs, ...)      -> (last_logits, cache)
    decode_step(params, cache, ...)   -> (logits, cache)

The stack is ``prefix blocks + cycles + suffix blocks`` as in the
reference (``layout``).  The reference stacks each cycle slot's
parameters on a leading layer axis for ``lax.scan``; here a Python loop
runs the layers, so the parameters and caches of a cycle slot are a list
over cycles: ``stack["cycle"][j][c]`` is slot j of cycle c.
``interop.lm_params_from_numpy`` unstacks the reference's tree.

An encoder-decoder model (``cfg.is_encdec``) has an ``encoder`` stack of
``n_encoder_layers`` global blocks and its ``enc_norm``: ``prefill``
runs it non-causally over ``batch["frames"]`` (B, S_enc, d) and every
decoder block cross-attends to its output, whose keys and values the
prefill cache keeps (``ck``/``cv``) for decode.  A vision model
(``cfg.frontend == "vision"``) takes ``batch["patch_embeds"]`` (B, P,
d) in place of its first P token embeddings.  ``loss_fn`` is the
training forward: with ``opt.remat`` each cycle of the stack is a
``torch.utils.checkpoint`` region (non-reentrant), recomputed in the
backward as the reference's ``jax.checkpoint`` of its scan body is, and
``chunked_ce_loss`` checkpoints each sequence chunk of the unembedding
and cross-entropy, so the (B, S, V) logits never exist at once.
``input_specs`` belongs to the dry-run and waits with it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ModelOptions = T.ModelOptions


class StackLayout(NamedTuple):
    prefix: tuple[str, ...]
    cycle: tuple[str, ...]
    n_cycles: int
    suffix: tuple[str, ...]


def layout(cfg: ArchConfig) -> StackLayout:
    kinds = cfg.kinds()
    prefix = tuple(kinds[:cfg.first_k_dense])
    rest = kinds[cfg.first_k_dense:]
    cyc = tuple(cfg.layer_pattern)
    n_cycles = len(rest) // len(cyc)
    suffix = tuple(rest[n_cycles * len(cyc):])
    return StackLayout(prefix, cyc, n_cycles, suffix)


def encoder_layout(cfg: ArchConfig) -> StackLayout:
    return StackLayout((), ("global",), cfg.n_encoder_layers, ())


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_stack(gen: torch.Generator, cfg: ArchConfig, lay: StackLayout, *,
                with_cross: bool = False, dtype=torch.float32) -> dict:
    def block(kind):
        return T.init_block(gen, kind, cfg, with_cross=with_cross,
                            dtype=dtype)
    return {"prefix": [block(k) for k in lay.prefix],
            "cycle": [[block(k) for _ in range(lay.n_cycles)]
                      for k in lay.cycle],
            "suffix": [block(k) for k in lay.suffix]}


def init_lm(gen: torch.Generator, cfg: ArchConfig, *,
            dtype=torch.float32) -> dict:
    """Random weights at the reference's scales, drawn from ``gen`` on
    its device, stored in ``dtype``."""
    dev = gen.device
    p = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                   dtype=dtype),
         "stack": _init_stack(gen, cfg, layout(cfg),
                              with_cross=cfg.is_encdec, dtype=dtype),
         "final_norm": L.init_norm(cfg.norm, cfg.d_model, dtype=dtype,
                                   device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_lm_head(gen, cfg.d_model, cfg.vocab_size,
                                      dtype=dtype)
    if cfg.is_encdec:
        p["encoder"] = _init_stack(gen, cfg, encoder_layout(cfg),
                                   dtype=dtype)
        p["enc_norm"] = L.init_norm(cfg.norm, cfg.d_model, dtype=dtype,
                                    device=dev)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                dtype=torch.float32) -> dict:
    """The parameters of ``init_lm``.  The reference's ``init_params``
    also returns the logical sharding axes, which wait for the
    ``torch.distributed`` slice."""
    return init_lm(gen, cfg, dtype=dtype)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype=torch.bfloat16, device=None, s_enc: int = 0) -> dict:
    """A decode cache; ``s_enc`` is the encoder length of an
    encoder-decoder model's cross-attention keys."""
    lay = layout(cfg)

    def mk(kind):
        return T.init_block_cache(kind, cfg, batch, s_cache, dtype,
                                  with_cross=cfg.is_encdec, s_enc=s_enc,
                                  device=device)
    return {"prefix": [mk(k) for k in lay.prefix],
            "cycle": [[mk(k) for _ in range(lay.n_cycles)]
                      for k in lay.cycle],
            "suffix": [mk(k) for k in lay.suffix],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------
def apply_stack(stack_p, x, *, cfg: ArchConfig, opt: ModelOptions,
                positions, mode: str, lay: StackLayout, cache=None,
                memory=None, causal: bool = True, with_cross: bool = False,
                cache_len: int | None = None):
    """-> (x, new_cache, aux): every layer in order, a Python loop.  The
    cache is None in ``"train"`` mode."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {"prefix": [], "cycle": [[] for _ in lay.cycle],
                       "suffix": []}

    def run(kind, bp, x, c):
        return T.apply_block(kind, bp, x, cfg, opt, positions, mode=mode,
                             cache=c, memory=memory, causal=causal,
                             with_cross=with_cross, cache_len=cache_len)

    for j, kind in enumerate(lay.prefix):
        x, nc, a = run(kind, stack_p["prefix"][j], x,
                       cache["prefix"][j] if cache else None)
        aux = aux + a
        new_cache["prefix"].append(nc)

    def cycle_body(c, x):
        """Cycle c: -> (x, its aux, its caches)."""
        aux_c = torch.zeros((), dtype=torch.float32, device=x.device)
        ncs = []
        for j, kind in enumerate(lay.cycle):
            x, nc, a = run(kind, stack_p["cycle"][j][c], x,
                           cache["cycle"][j][c] if cache else None)
            aux_c = aux_c + a
            ncs.append(nc)
        return x, aux_c, ncs

    remat = opt.remat and mode == "train" and torch.is_grad_enabled()
    for c in range(lay.n_cycles):
        if remat:
            x, a, ncs = checkpoint(cycle_body, c, x, use_reentrant=False)
        else:
            x, a, ncs = cycle_body(c, x)
        aux = aux + a
        for j, nc in enumerate(ncs):
            new_cache["cycle"][j].append(nc)
    for j, kind in enumerate(lay.suffix):
        x, nc, a = run(kind, stack_p["suffix"][j], x,
                       cache["suffix"][j] if cache else None)
        aux = aux + a
        new_cache["suffix"].append(nc)
    return x, None if mode == "train" else new_cache, aux


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch: dict, cfg: ArchConfig, opt: ModelOptions):
    x = L.embed_tokens(params["embed"], batch["tokens"],
                       scale=cfg.embed_scale, dtype=opt.dtype)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(opt.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def encode(params, frames, cfg: ArchConfig, opt: ModelOptions):
    """The encoder over ``frames`` (B, S_enc, d), non-causal, then
    ``enc_norm``: the memory every decoder block cross-attends to."""
    m = frames.to(opt.dtype)
    B, S = m.shape[0], m.shape[1]
    pos = torch.arange(S, device=m.device)[None].expand(B, S)
    memory, _, _ = apply_stack(params["encoder"], m, cfg=cfg, opt=opt,
                               positions=pos, mode="train",
                               lay=encoder_layout(cfg), causal=False)
    return L.apply_norm(cfg.norm, params["enc_norm"], memory, cfg.norm_eps)


def _logits(params, x, cfg: ArchConfig):
    return L.unembed(params.get("lm_head"), params["embed"], x,
                     softcap=cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, batch: dict, cfg: ArchConfig, opt: ModelOptions,
            cache_len: int | None = None):
    """Forward over the prompt ``batch["tokens"]`` (B, S) (with
    ``"frames"`` for an encoder-decoder, optional ``"patch_embeds"`` for
    a vision model); returns (last-token logits (B, 1, V) f32, cache).
    ``cache_len`` sets the decode-cache capacity (>= prompt length)."""
    lay = layout(cfg)
    memory = encode(params, batch["frames"], cfg, opt) if cfg.is_encdec \
        else None
    x = _embed_inputs(params, batch, cfg, opt)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, cache, _ = apply_stack(params["stack"], x, cfg=cfg, opt=opt,
                              positions=positions, mode="prefill", lay=lay,
                              memory=memory, with_cross=cfg.is_encdec,
                              cache_len=cache_len)
    x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x[:, -1:], cfg)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ArchConfig, opt: ModelOptions):
    """One token for every sequence. tokens: (B, 1) -> (logits, cache).
    The cache's tensors are updated in place and returned."""
    lay = layout(cfg)
    pos = cache["pos"]                                   # (B,)
    x = L.embed_tokens(params["embed"], tokens, scale=cfg.embed_scale,
                       dtype=opt.dtype)
    x, new_cache, _ = apply_stack(params["stack"], x, cfg=cfg, opt=opt,
                                  positions=pos[:, None], mode="decode",
                                  lay=lay, cache=cache,
                                  with_cross=cfg.is_encdec)
    x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x, cfg)
    new_cache["pos"] = pos + 1
    return logits, new_cache


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross-entropy; logits never fully materialized)
# ---------------------------------------------------------------------------
def chunked_ce_loss(params, x, labels, cfg: ArchConfig, opt: ModelOptions,
                    z_loss: float = 1e-4):
    """x: (B, S, D) final hidden; labels (B, S) integer, -1 = masked.
    -> (mean NLL + z_loss * mean lse^2 over the valid labels, their
    int32 count).  S is padded to a multiple of the chunk with label -1;
    each chunk's logits, log-sum-exp and gold logit are f32 and the
    chunk is recomputed in the backward."""
    B, S, D = x.shape
    c = min(opt.loss_chunk, S)
    pad = (-S) % c
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def chunk_loss(xc, lc):
        logits = _logits(params, xc, cfg)               # (B, c, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(lc, min=0)[..., None].long())[..., 0]
        valid = lc >= 0
        nll = torch.where(valid, lse - gold, 0.0)
        zl = torch.where(valid, lse * lse, 0.0)
        return torch.sum(nll), torch.sum(zl), \
            torch.sum(valid, dtype=torch.int32)

    remat = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for s in range(0, S + pad, c):
        xc, lc = x[:, s:s + c], labels[:, s:s + c]
        if remat:
            n, z, k = checkpoint(chunk_loss, xc, lc, use_reentrant=False)
        else:
            n, z, k = chunk_loss(xc, lc)
        loss_sum, z_sum, count = loss_sum + n, z_sum + z, count + k
    denom = torch.clamp(count, min=1)
    return loss_sum / denom + z_loss * z_sum / denom, count


def loss_fn(params, batch: dict, cfg: ArchConfig, opt: ModelOptions):
    """Training forward.  batch: ``tokens``/``labels`` (B, S) (+
    ``patch_embeds`` for a vision model, ``frames`` for an
    encoder-decoder).  -> (loss, {ce, aux, tokens}): the chunked
    cross-entropy plus the MoE router's ``aux_loss_weight * aux``."""
    lay = layout(cfg)
    memory = encode(params, batch["frames"], cfg, opt) if cfg.is_encdec \
        else None
    x = _embed_inputs(params, batch, cfg, opt)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, _, aux = apply_stack(params["stack"], x, cfg=cfg, opt=opt,
                            positions=positions, mode="train", lay=lay,
                            memory=memory, with_cross=cfg.is_encdec)
    x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    ce, count = chunked_ce_loss(params, x, batch["labels"], cfg, opt)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    loss = ce + aux_w * aux
    return loss, {"ce": ce, "aux": aux, "tokens": count}
