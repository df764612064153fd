"""Sliding-window attention, its ring cache and tiny gemma3-12b: the
port against the JAX package, on the CPU, in f32.

The same numpy inputs go through ``repro.models`` and
``repro_torch.models``; the JAX package's own ``init_params`` weights
are carried across with ``interop.lm_params_from_numpy``.  On the CPU
the port's prefill attention is the flash kernel's plain version (the
dense masked softmax with the window band), where the reference runs its
blocked ``sliding_window_attention``.  Tolerances: 1e-5 on the attention
functions and the ring cache, 1e-4 (atol = rtol) on the models' logits
and caches through prefill and decode.  The prompt (20) is longer than
the tiny window (16), so prefill masks the band and fills the ring past
its wrap, and decode wraps it again.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.torch

ATOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT, DECODE = 20, 6


def _t(x):
    return torch.as_tensor(np.array(x, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S,window,G,softcap", [
    (40, 16, 2, 0.0), (37, 16, 1, 0.0), (48, 8, 4, 20.0), (12, 16, 2, 0.0),
    (33, 32, 2, 0.0)])
def test_sliding_window_attention(S, window, G, softcap):
    """The port's flash-kernel route (plain version on the CPU) against
    the reference's blocked band, ragged S and S below the window."""
    rng = np.random.default_rng(S + window)
    B, KV, hd = 2, 2, 16
    q = rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    # the reference takes full heads (apply_attention repeats them)
    want = JATT.sliding_window_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, 2),
        jnp.repeat(jnp.asarray(v), G, 2), jnp.asarray(pos), window=window,
        softcap=softcap)
    got = TATT.sliding_window_attention(_t(q), _t(k), _t(v), _t(pos),
                                        window=window, softcap=softcap)
    assert got.shape == (B, S, KV * G, hd)
    _close(got, want, ATOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_local_ring(window):
    """``_decode_local`` on a ring of 8 slots that wraps (positions past
    the ring write over the oldest slot), with and without the window
    mask, against the reference's one-device ``_decode_local``."""
    rng = np.random.default_rng(3 + window)
    B, L, H, KV, hd = 2, 8, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    ck = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    pos = np.array([5, 21], np.int32)
    sp = np.stack([np.where(np.arange(L) < 5, np.arange(L), -1),
                   13 + (np.arange(L) - 13) % L]).astype(np.int32)
    got = TATT._decode_local(_t(q), _t(kn), _t(vn), _t(ck), _t(cv), _t(sp),
                             _t(pos), window=window, softcap=0.0, chunk=4)
    want = JATT._decode_local(*map(jnp.asarray, (q, kn, vn, ck, cv, sp,
                                                 pos)),
                              s_total=L, window=window, softcap=0.0,
                              chunk=4, seq_axes=())
    for g, w in zip(got, want):
        _close(g, w, ATOL)
    assert int(got[3][1, 21 % L]) == 21


def test_qk_norm_and_local_theta():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(TL.rms_norm_headwise(_t(scale), _t(x)),
           JL.rms_norm_headwise(jnp.asarray(scale), jnp.asarray(x)), ATOL)
    cfg, jcfg = get_arch("gemma3-12b"), jax_get_arch("gemma3-12b")
    for kind in ("local", "global"):
        assert TT._rope_theta(cfg, kind) == JT._rope_theta(jcfg, kind)
    assert TT._rope_theta(cfg, "local") == 1e4


# ---------------------------------------------------------------------------
# Tiny models: prefill and decode against the JAX package
# ---------------------------------------------------------------------------
def cache_leaves(cache, n_cycles=None):
    """A port cache (``n_cycles`` given: each cycle slot a list over
    cycles, stacked here) or a JAX cache (stacked already), flattened in
    one order: prefix, cycle slots, suffix, each entry by sorted key."""
    out = []
    for part in ("prefix", "cycle", "suffix"):
        for entry in cache[part]:
            if part == "cycle" and n_cycles is not None:
                out += [torch.stack([entry[i][k] for i in range(n_cycles)])
                        for k in sorted(entry[0])]
            else:
                out += [entry[k] for k in sorted(entry)]
    return out + [cache["pos"]]


def jitter_zero_leaves(jparams, jitter: float, seed: int):
    """Seeded noise of scale ``jitter`` on every all-zero leaf of a JAX
    parameter tree (biases, conv taps, norm offsets, which the reference
    initializes to zero); the tree itself when ``jitter`` is 0."""
    if not jitter:
        return jparams
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a if np.asarray(a).any() else jnp.asarray(
            jitter * rng.standard_normal(a.shape), a.dtype), jparams)


def assert_xlstm_live(params, cfg) -> None:
    """Every mLSTM and sLSTM block of the port's stack adds a nonzero
    output on a seeded input.  With the initializers' zero conv taps and
    biases each adds exactly 0, and a check of the model would pass
    whatever the blocks compute."""
    from repro_torch.models import xlstm as TXL
    lay = TM.layout(cfg)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 6, cfg.d_model)).astype(np.float32))
    for part, kinds in (("prefix", lay.prefix), ("cycle", lay.cycle),
                        ("suffix", lay.suffix)):
        for j, kind in enumerate(kinds):
            if kind not in ("mlstm", "slstm"):
                continue
            blocks = params["stack"][part][j]
            for p in blocks if part == "cycle" else [blocks]:
                fn = TXL.apply_mlstm_block if kind == "mlstm" \
                    else TXL.apply_slstm_block
                y = fn(p["cell"], x, cfg.n_heads)[0]
                assert float(y.abs().max()) > 1e-3, (cfg.name, part, j)


def run_both(cfg, jcfg, prompt_len=PROMPT, n_decode=DECODE, seed=0,
             extra=None, jitter=0.0, **opt_kw):
    """The tiny model ``cfg`` through the JAX package (jitted, its own
    ``init_params``) and the port (the same weights carried across):
    prefill with ``cache_len = prompt + n_decode``, then ``n_decode``
    greedy steps fed the JAX model's tokens.  ``extra``: more numpy
    inputs of the batch (``frames``, ``patch_embeds``); ``opt_kw``: more
    ``ModelOptions`` fields for both; ``jitter`` > 0: seeded noise of
    that scale on every all-zero leaf (biases, conv taps, RMSNorm
    scales), which the reference initializes to zero.  -> a list of
    (what, port output, JAX output) pairs: logits, then every cache
    leaf."""
    jparams = jitter_zero_leaves(
        jax.jit(lambda key: JM.init_params(key, jcfg)[0])(
            jax.random.PRNGKey(seed)), jitter, seed + 9)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  cfg, device="cpu")
    assert_xlstm_live(params, cfg)
    jopt = JM.ModelOptions(dtype=jnp.float32, remat=False, **opt_kw)
    opt = TM.ModelOptions(dtype=torch.float32, **opt_kw)
    cl = prompt_len + n_decode
    prompt = np.random.default_rng(seed + 4).integers(0, cfg.vocab_size,
                                                      (2, prompt_len))
    batch = {"tokens": prompt, **(extra or {})}
    jprefill = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, jopt,
                                               cache_len=cl))
    jdecode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg, jopt))
    n_cycles = TM.layout(cfg).n_cycles
    jl, jc = jprefill(jparams, {k: jnp.asarray(v) for k, v in
                                batch.items()})
    tl, tc = TM.prefill(params, {k: torch.as_tensor(v) for k, v in
                                 batch.items()}, cfg, opt, cache_len=cl)
    pairs = []

    def record(what, tl, tc, jl, jc):
        pairs.append((f"{what} logits", tl, np.asarray(jl)))
        for i, (g, w) in enumerate(zip(cache_leaves(tc, n_cycles),
                                       cache_leaves(jc))):
            pairs.append((f"{what} cache leaf {i}", g, np.asarray(w)))

    record("prefill", tl, tc, jl, jc)
    for step in range(n_decode):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = TM.decode_step(params, tc, torch.as_tensor(tok.copy()), cfg,
                                opt)
        record(f"decode {step}", tl, tc, jl, jc)
    return pairs


@pytest.fixture(scope="module")
def gemma_pairs():
    cfg = get_arch("gemma3-12b").tiny()
    return cfg, run_both(cfg, jax_get_arch("gemma3-12b").tiny())


def test_gemma3_config_and_layout_equal_reference():
    mine, ref = get_arch("gemma3-12b"), jax_get_arch("gemma3-12b")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.tiny()) == dataclasses.asdict(ref.tiny())
    assert TM.layout(mine) == tuple(JM.layout(ref))
    assert TM.layout(mine).n_cycles == 8


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tiny_gemma3_matches_reference(gemma_pairs, phase):
    """Tiny gemma3-12b (QK-norm, sandwich norms, 5 local : 1 global, two
    RoPE thetas, sqrt(d) embedding scale): logits and every cache leaf
    at 1e-4, the local rings of min(16, 26) slots wrapped."""
    cfg, pairs = gemma_pairs
    seen = 0
    for what, got, want in pairs:
        if what.startswith(phase):
            assert tuple(got.shape) == want.shape, what
            np.testing.assert_allclose(got.numpy(), want, err_msg=what,
                                       **TOL)
            seen += 1
    assert seen > 0
    ring = TM.init_cache(cfg, 1, PROMPT + DECODE, torch.float32)
    assert ring["cycle"][0][0]["k"].shape[1] == cfg.window == 16
    assert ring["cycle"][5][0]["k"].shape[1] == PROMPT + DECODE


def test_gemma3_init_and_cache_shapes_match_reference():
    """The port's own initializer gives the reference's tree (keys and
    shapes, QK-norm and post-norm leaves included) and ``init_cache``
    the reference's shapes."""
    cfg = get_arch("gemma3-12b").tiny()
    jcfg = jax_get_arch("gemma3-12b").tiny()
    mine = TM.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                jcfg)[0])
    n = TM.layout(cfg).n_cycles

    def shapes(tree, cycle=False):
        if isinstance(tree, dict):
            return {k: shapes(v, cycle) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v, cycle) for v in tree]
        return tuple(tree.shape)

    got = shapes(mine)
    got["stack"]["cycle"] = [jax.tree.map(lambda s: (n,) + s, slot[0],
                                          is_leaf=lambda x: isinstance(x,
                                                                       tuple))
                             for slot in got["stack"]["cycle"]]
    assert got == shapes(ref)
    assert set(mine["stack"]["cycle"][0][0]["attn"]) >= {"qn", "kn"}
    assert {"ln1b", "ln2b"} <= set(mine["stack"]["cycle"][5][0])
    tc = TM.init_cache(cfg, 2, 40, torch.float32)
    jc = JM.init_cache(jcfg, 2, 40, jnp.float32)
    assert [tuple(x.shape) for x in cache_leaves(tc, n)] \
        == [x.shape for x in cache_leaves(jc)]
