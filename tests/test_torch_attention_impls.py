"""``hierarchical_causal`` and ``block_causal``, and the attention
sub-layer under ``attn_impl`` ``"hier"`` and ``"block"``: the port
against the JAX package, on the CPU, in f32.

Both functions are XLA code in the reference with no Pallas source, and
plain PyTorch in the port.  They are held to the reference's at 1e-5 on
the same numpy inputs (GQA groups of 1 and 2, with and without softcap,
2 to 8 base chunks), then the sub-layer (``transformer.apply_attention``,
prefill) with its cache at 1e-5, and tiny qwen2-72b through prefill and
decode at 1e-4 under each option with a chunk of 8 so that a 32-token
prompt takes the option's branch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_attention import run_both

from repro.configs.base import get_arch as jax_get_arch
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs.base import get_arch
from repro_torch.models import attention as TATT
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.torch

ATOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
J_HIER = jax.jit(JATT.hierarchical_causal,
                 static_argnames=("softcap", "base_chunk"))
J_BLOCK = jax.jit(JATT.block_causal, static_argnames=("softcap", "chunk"))
J_ATTN = jax.jit(JT.apply_attention, static_argnums=(2, 3, 4),
                 static_argnames=("causal", "mode", "pctx", "cache_len"))


def _qkv(S, G, seed):
    rng = np.random.default_rng(seed)
    B, KV, hd = 2, 2, 16
    q = rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.as_tensor(np.array(x, copy=True))


@pytest.mark.parametrize("S,chunk,G,softcap", [
    (32, 8, 1, 0.0), (64, 8, 2, 0.0), (32, 16, 2, 20.0), (16, 16, 1, 0.0),
    (64, 32, 2, 0.0)])
def test_hierarchical_and_block_causal(S, chunk, G, softcap):
    q, k, v = _qkv(S, G, S + chunk + G)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = TATT.hierarchical_causal(_t(q), _t(k), _t(v), softcap=softcap,
                                   base_chunk=chunk)
    want = J_HIER(jq, jk, jv, softcap=softcap, base_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    got = TATT.block_causal(_t(q), _t(k), _t(v), softcap=softcap,
                            chunk=chunk)
    want = J_BLOCK(jq, jk, jv, softcap=softcap, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    # both are exact causal attention
    causal = TATT.flash(_t(q), _t(k), _t(v), causal=True, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), causal.numpy(), **ATOL)


def test_refuse_ragged_chunks():
    q, k, v = _qkv(24, 1, 0)
    with pytest.raises(ValueError, match="divisible"):
        TATT.hierarchical_causal(_t(q), _t(k), _t(v), base_chunk=16)
    with pytest.raises(ValueError, match="divide"):
        TATT.block_causal(_t(q), _t(k), _t(v), chunk=16)


@pytest.mark.parametrize("impl", ["hier", "block"])
@pytest.mark.parametrize("S", [32, 8])
def test_apply_attention_under_attn_impl(impl, S):
    """The prefill sub-layer of tiny qwen2-72b (GQA 4 : 2, QKV bias) under
    the option: output and cache; at S = 8 = kv_chunk the reference
    falls through to its chunked scan, the port to the flash kernel's
    plain version."""
    cfg, jcfg = get_arch("qwen2-72b").tiny(), jax_get_arch("qwen2-72b").tiny()
    p = jax.tree.map(np.asarray, jax.jit(lambda key: JL.split_annotated(
        JT.init_attention(key, jcfg))[0])(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(S)
    p["bq"] = (0.2 * rng.standard_normal(p["bq"].shape)).astype(np.float32)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    opt = TM.ModelOptions(dtype=torch.float32, attn_impl=impl, kv_chunk=8)
    jopt = JM.ModelOptions(dtype=jnp.float32, remat=False, attn_impl=impl,
                           kv_chunk=8)
    y, cache = TT.apply_attention({k: _t(a) for k, a in p.items()}, _t(x),
                                  cfg, opt, "global", _t(pos),
                                  mode="prefill", cache_len=S + 4)
    jy, jc = J_ATTN({k: jnp.asarray(a) for k, a in p.items()},
                    jnp.asarray(x), jcfg, jopt, "global", jnp.asarray(pos),
                    mode="prefill", pctx=None, cache_len=S + 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **ATOL)
    for key in jc:
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]),
                                   **ATOL)


@pytest.mark.parametrize("impl", ["hier", "block"])
def test_tiny_model_under_attn_impl(impl):
    """Tiny qwen2-72b, prompt 32 with a chunk of 8: prefill through the
    option's branch, then 3 decode steps, logits and cache at 1e-4."""
    cfg = get_arch("qwen2-72b").tiny()
    pairs = run_both(cfg, jax_get_arch("qwen2-72b").tiny(), prompt_len=32,
                     n_decode=3, seed=5, attn_impl=impl, kv_chunk=8)
    for what, got, want in pairs:
        assert tuple(got.shape) == want.shape, what
        np.testing.assert_allclose(got.numpy(), want, err_msg=what, **TOL)
