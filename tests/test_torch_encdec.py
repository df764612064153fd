"""Encoder-decoder and vision pieces of the port against the JAX package,
on the CPU, in f32.

``project_memory_kv``, cross-attention at prefill (S queries) and at
decode (one query) against S_enc encoder keys, non-causal
self-attention (the encoder's), the plain MLP and LayerNorm, at 1e-5.
On the CPU the port's cross- and non-causal attention is the flash
kernel's plain version, where the reference scans ``flash_chunked``.
Then tiny seamless-m4t-large-v2 (2 encoder + 2 decoder layers) over
seeded frames and tiny phi-3-vision-4.2b with seeded patch embeddings
spliced over its first prompt positions, through prefill and decode at
1e-4 (atol = rtol): logits and every cache leaf, the decoder's ``ck`` and
``cv`` (written at prefill, carried through decode) included.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_attention import run_both

from repro.configs.base import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.torch

ATOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
SEAMLESS = "seamless-m4t-large-v2"
PHI = "phi-3-vision-4.2b"
PROMPT, DECODE, S_ENC = 20, 5, 28
# the reference's attention jitted (eager, its chunk scan compiles anew)
J_CROSS = jax.jit(JT.apply_cross_attention, static_argnums=(3, 4),
                  static_argnames="mode")
J_ATTN = jax.jit(JT.apply_attention, static_argnums=(2, 3, 4),
                 static_argnames=("causal", "mode", "pctx"))


def _t(x):
    return torch.as_tensor(np.array(x, copy=True))


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _opts():
    return (TM.ModelOptions(dtype=torch.float32, kv_chunk=8),
            JM.ModelOptions(dtype=jnp.float32, remat=False, kv_chunk=8))


@pytest.fixture(scope="module")
def attn_params():
    """Reference-initialized self- and cross-attention weights of tiny
    seamless (biases on), the biases given seeded noise."""
    cfg = jax_get_arch(SEAMLESS).tiny()
    rng = np.random.default_rng(1)

    def init(key, cross):
        p = jax.jit(lambda k: JL.split_annotated(
            JT.init_attention(k, cfg, cross=cross))[0])(key)
        return {k: np.asarray(v) if np.asarray(v).any() else
                (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in p.items()}
    return init(jax.random.PRNGKey(2), False), init(jax.random.PRNGKey(3),
                                                    True)


@pytest.mark.parametrize("sq", [1, 9, 28])
def test_cross_attention(attn_params, sq):
    """K/V projected from the memory once, then cross-attention of sq
    queries (1: a decode step) against S_enc = 28 keys."""
    _, cross = attn_params
    cfg, jcfg = get_arch(SEAMLESS).tiny(), jax_get_arch(SEAMLESS).tiny()
    opt, jopt = _opts()
    rng = np.random.default_rng(sq)
    mem = rng.standard_normal((2, S_ENC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in cross.items()}
    jp = {k: jnp.asarray(v) for k, v in cross.items()}
    tkv = TT.project_memory_kv(tp, _t(mem), cfg)
    jkv = JT.project_memory_kv(jp, jnp.asarray(mem), jcfg)
    for g, w in zip(tkv, jkv):
        assert tuple(g.shape) == w.shape == (2, S_ENC, cfg.n_kv_heads,
                                             cfg.hd)
        _close(g, w)
    mode = "decode" if sq == 1 else "prefill"
    _close(TT.apply_cross_attention(tp, _t(x), tkv, cfg, opt, mode=mode),
           J_CROSS(jp, jnp.asarray(x), jkv, jcfg, jopt, mode=mode))


@pytest.mark.parametrize("S", [7, 24])
def test_non_causal_self_attention(attn_params, S):
    """The encoder's attention: RoPE on q and k, no mask, no cache."""
    self_p, _ = attn_params
    cfg, jcfg = get_arch(SEAMLESS).tiny(), jax_get_arch(SEAMLESS).tiny()
    opt, jopt = _opts()
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    y, cache = TT.apply_attention({k: _t(v) for k, v in self_p.items()},
                                  _t(x), cfg, opt, "global", _t(pos),
                                  causal=False, mode="train")
    jy, _ = J_ATTN({k: jnp.asarray(v) for k, v in self_p.items()},
                   jnp.asarray(x), jcfg, jopt, "global", jnp.asarray(pos),
                   causal=False, mode="train", pctx=None)
    assert cache is None
    _close(y, jy)


def test_plain_mlp_and_layernorm():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 2 + 0.5
    p = {"wi": rng.standard_normal((64, 96)).astype(np.float32) * 0.125,
         "bi": rng.standard_normal(96).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((96, 64)).astype(np.float32) * 0.1,
         "bo": rng.standard_normal(64).astype(np.float32) * 0.1}
    for act in ("gelu", "silu", "relu"):
        _close(TL.apply_plain_mlp({k: _t(v) for k, v in p.items()}, _t(x),
                                  act),
               JL.apply_plain_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), act))
    ln = {"scale": rng.standard_normal(64).astype(np.float32),
          "bias": rng.standard_normal(64).astype(np.float32)}
    _close(TL.apply_norm("layernorm", {k: _t(v) for k, v in ln.items()},
                         _t(x), 1e-5),
           JL.apply_norm("layernorm", {k: jnp.asarray(v)
                                       for k, v in ln.items()},
                         jnp.asarray(x), 1e-5))
    init = TL.init_norm("layernorm", 64)
    assert set(init) == {"scale", "bias"}
    assert bool((init["scale"] == 1).all()) and bool((init["bias"] == 0).all())


# ---------------------------------------------------------------------------
# Tiny seamless-m4t-large-v2 and phi-3-vision-4.2b
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seamless_pairs():
    cfg = get_arch(SEAMLESS).tiny()
    frames = np.random.default_rng(5).standard_normal(
        (2, S_ENC, cfg.d_model)).astype(np.float32)
    return run_both(cfg, jax_get_arch(SEAMLESS).tiny(), PROMPT, DECODE,
                    seed=1, extra={"frames": frames}, jitter=0.1)


@pytest.fixture(scope="module")
def phi_pairs():
    cfg = get_arch(PHI).tiny()
    patches = np.random.default_rng(6).standard_normal(
        (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return run_both(cfg, jax_get_arch(PHI).tiny(), PROMPT, DECODE, seed=2,
                    extra={"patch_embeds": patches}, jitter=0.1)


def _check(pairs, phase):
    seen = 0
    for what, got, want in pairs:
        if what.startswith(phase):
            assert tuple(got.shape) == want.shape, what
            np.testing.assert_allclose(got.numpy(), want, err_msg=what,
                                       **TOL)
            seen += 1
    assert seen > 0


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tiny_seamless_matches_reference(seamless_pairs, phase):
    _check(seamless_pairs, phase)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tiny_phi3_vision_with_patches_matches_reference(phi_pairs, phase):
    _check(phi_pairs, phase)


def test_encoder_memory_and_cross_cache():
    """The prefill cache's ``ck``/``cv`` are the cross-attention K/V of
    the encoder's output, ``init_cache(s_enc=)`` gives the reference's
    shapes, decode carries them unchanged, and the patch splice replaces
    exactly the first P embeddings."""
    cfg, jcfg = get_arch(SEAMLESS).tiny(), jax_get_arch(SEAMLESS).tiny()
    opt = TM.ModelOptions(dtype=torch.float32)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(8)
    frames = _t(rng.standard_normal((1, S_ENC, cfg.d_model)).astype(
        np.float32))
    tokens = _t(rng.integers(0, cfg.vocab_size, (1, 6)))
    _, cache = TM.prefill(params, {"tokens": tokens, "frames": frames}, cfg,
                          opt, cache_len=8)
    memory = TM.encode(params, frames, cfg, opt)
    layer = cache["cycle"][0][1]
    ck, cv = TT.project_memory_kv(params["stack"]["cycle"][0][1]["cross"],
                                  memory, cfg)
    torch.testing.assert_close(layer["ck"], ck, rtol=0, atol=0)
    torch.testing.assert_close(layer["cv"], cv, rtol=0, atol=0)
    before = layer["ck"].clone()
    _, cache = TM.decode_step(params, cache, tokens[:, :1], cfg, opt)
    torch.testing.assert_close(cache["cycle"][0][1]["ck"], before, rtol=0,
                               atol=0)
    tc = TM.init_cache(cfg, 2, 12, torch.float32, s_enc=S_ENC)
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 12, jnp.float32,
                                              s_enc=S_ENC))
    assert set(tc["cycle"][0][0]) == set(jc["cycle"][0]) \
        == {"k", "v", "slot_pos", "ck", "cv"}
    n = TM.layout(cfg).n_cycles
    for key, leaf in jc["cycle"][0].items():
        assert (n,) + tuple(tc["cycle"][0][0][key].shape) == leaf.shape, key
    pcfg = get_arch(PHI).tiny()
    pparams = TM.init_params(torch.Generator().manual_seed(1), pcfg)
    toks = _t(rng.integers(0, pcfg.vocab_size, (1, 12)))
    pe = _t(rng.standard_normal((1, pcfg.n_frontend_tokens, pcfg.d_model))
            .astype(np.float32))
    x = TM._embed_inputs(pparams, {"tokens": toks, "patch_embeds": pe}, pcfg,
                         opt)
    plain = TM._embed_inputs(pparams, {"tokens": toks}, pcfg, opt)
    P = pcfg.n_frontend_tokens
    torch.testing.assert_close(x[:, :P], pe, rtol=0, atol=0)
    torch.testing.assert_close(x[:, P:], plain[:, P:], rtol=0, atol=0)
