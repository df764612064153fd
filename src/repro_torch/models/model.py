"""Language-model assembly: embeddings, the block stack, prefill, decode.

The serving half of ``repro/models/model.py``:

    init_lm(gen, cfg, dtype=)         -> parameter dict
    init_cache(cfg, batch, s_cache)   -> decode cache dict
    prefill(params, inputs, ...)      -> (last_logits, cache)
    decode_step(params, cache, ...)   -> (logits, cache)

The stack is ``prefix blocks + cycles + suffix blocks`` as in the
reference (``layout``).  The reference stacks each cycle slot's
parameters on a leading layer axis for ``lax.scan``; here a Python loop
runs the layers, so the parameters and caches of a cycle slot are a list
over cycles: ``stack["cycle"][j][c]`` is slot j of cycle c.
``interop.lm_params_from_numpy`` unstacks the reference's tree.
``loss_fn``, ``chunked_ce_loss`` and the encoder-decoder and vision
branches wait for the training slice (ROADMAP queue A16).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def _check_arch(cfg: ArchConfig) -> None:
    if cfg.is_encdec or cfg.frontend is not None:
        raise T.not_ported("encoder-decoder and vision models",
                           "queue A16: encoder-decoder, vision")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_lm(gen: torch.Generator, cfg: ArchConfig, *,
            dtype=torch.float32) -> dict:
    """Random weights at the reference's scales, drawn from ``gen`` on
    its device, stored in ``dtype``."""
    _check_arch(cfg)
    lay = layout(cfg)

    def block(kind):
        return T.init_block(gen, kind, cfg, dtype=dtype)

    p = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                   dtype=dtype),
         "stack": {"prefix": [block(k) for k in lay.prefix],
                   "cycle": [[block(k) for _ in range(lay.n_cycles)]
                             for k in lay.cycle],
                   "suffix": [block(k) for k in lay.suffix]},
         "final_norm": L.init_norm(cfg.norm, cfg.d_model, dtype=dtype,
                                   device=gen.device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_lm_head(gen, cfg.d_model, cfg.vocab_size,
                                      dtype=dtype)
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
               dtype=torch.bfloat16, device=None) -> dict:
    lay = layout(cfg)

    def mk(kind):
        return T.init_block_cache(kind, cfg, batch, s_cache, dtype,
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
                cache_len: int | None = None):
    """-> (x, new_cache, aux): every layer in order, a Python loop."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {"prefix": [], "cycle": [[] for _ in lay.cycle],
                       "suffix": []}

    def run(kind, bp, x, c):
        return T.apply_block(kind, bp, x, cfg, opt, positions, mode=mode,
                             cache=c, cache_len=cache_len)

    for j, kind in enumerate(lay.prefix):
        x, nc, a = run(kind, stack_p["prefix"][j], x,
                       cache["prefix"][j] if cache else None)
        aux = aux + a
        new_cache["prefix"].append(nc)
    for c in range(lay.n_cycles):
        for j, kind in enumerate(lay.cycle):
            x, nc, a = run(kind, stack_p["cycle"][j][c], x,
                           cache["cycle"][j][c] if cache else None)
            aux = aux + a
            new_cache["cycle"][j].append(nc)
    for j, kind in enumerate(lay.suffix):
        x, nc, a = run(kind, stack_p["suffix"][j], x,
                       cache["suffix"][j] if cache else None)
        aux = aux + a
        new_cache["suffix"].append(nc)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch: dict, cfg: ArchConfig, opt: ModelOptions):
    _check_arch(cfg)
    return L.embed_tokens(params["embed"], batch["tokens"],
                          scale=cfg.embed_scale, dtype=opt.dtype)


def _logits(params, x, cfg: ArchConfig):
    return L.unembed(params.get("lm_head"), params["embed"], x,
                     softcap=cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, batch: dict, cfg: ArchConfig, opt: ModelOptions,
            cache_len: int | None = None):
    """Forward over the prompt ``batch["tokens"]`` (B, S); returns
    (last-token logits (B, 1, V) f32, cache).  ``cache_len`` sets the
    decode-cache capacity (>= prompt length)."""
    lay = layout(cfg)
    x = _embed_inputs(params, batch, cfg, opt)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    x, cache, _ = apply_stack(params["stack"], x, cfg=cfg, opt=opt,
                              positions=positions, mode="prefill", lay=lay,
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
                                  lay=lay, cache=cache)
    x = L.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x, cfg)
    new_cache["pos"] = pos + 1
    return logits, new_cache
