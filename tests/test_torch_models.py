"""The port's model stack against the JAX package's, on the CPU, in f32.

The same numpy inputs and the JAX package's own ``init_params`` weights
(carried across by ``interop.lm_params_from_numpy``) go through the JAX
functions and their counterparts in ``repro_torch.models``.  On the CPU
the port's kernel wrappers run their plain versions (flash attention:
the dense masked softmax; grouped matmul: the masked einsum), where the
JAX package computes the same functions with ``flash_chunked`` and two
einsums.  So the two agree up to float summation order: tolerance
atol = rtol = 1e-4 on every output, logits and caches.
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
from repro.models import moe as JMOE
from repro_torch.configs.base import get_arch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen2-1.5b", "deepseek-moe-16b")


def _jax_init(cfg, seed):
    """The JAX package's ``init_params`` weights, jitted (its eager run
    takes ten times as long on the CPU)."""
    return jax.jit(lambda key: JM.init_params(key, cfg)[0])(
        jax.random.PRNGKey(seed))



def _t(x):
    return torch.as_tensor(np.asarray(x).copy())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def test_configs_equal_reference():
    for name in ARCHS:
        mine, ref = get_arch(name), jax_get_arch(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert dataclasses.asdict(mine.tiny()) == \
            dataclasses.asdict(ref.tiny())
        assert mine.kinds() == ref.kinds()
        assert TM.layout(mine) == tuple(JM.layout(ref))


def test_norm_rope_gated_mlp():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(TL.apply_norm("rmsnorm", {"scale": _t(scale)}, _t(x), 1e-6),
           JL.apply_norm("rmsnorm", {"scale": jnp.asarray(scale)},
                         jnp.asarray(x), 1e-6))
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
    _close(TL.apply_rope(_t(q), _t(pos), 1e6),
           JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6))
    p = {"wi": rng.standard_normal((64, 2, 96)).astype(np.float32) * 0.125,
         "wo": rng.standard_normal((96, 64)).astype(np.float32) * 0.1}
    for act in ("silu", "gelu"):
        _close(TL.apply_gated_mlp({k: _t(v) for k, v in p.items()}, _t(x),
                                  act),
               JL.apply_gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), act))


@pytest.mark.parametrize("causal,window,softcap,chunk", [
    (True, 0, 0.0, 1024), (True, 0, 0.0, 16), (True, 8, 0.0, 16),
    (False, 0, 0.0, 16), (True, 0, 20.0, 24)])
def test_flash_chunked(causal, window, softcap, chunk):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    valid = rng.random((2, 40)) < 0.9
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk)
    got = TATT.flash_chunked(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                             k_valid=_t(valid), **kw)
    want = JATT.flash_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(pos),
                              k_valid=jnp.asarray(valid), **kw)
    _close(got, want)


def test_decode_update_attend():
    rng = np.random.default_rng(2)
    B, L, H, KV, hd = 2, 24, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    ck = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    pos = np.array([10, 30], np.int32)          # the second wraps the ring
    sp = np.stack([np.where(np.arange(L) < 10, np.arange(L), -1),
                   np.arange(L) + 7]).astype(np.int32)
    got = TATT.decode_update_attend(_t(q), _t(kn), _t(vn), _t(ck), _t(cv),
                                    _t(sp), _t(pos), chunk=16)
    want = JATT.decode_update_attend(*map(jnp.asarray, (q, kn, vn, ck, cv,
                                                        sp, pos)), chunk=16)
    for g, w in zip(got, want):
        _close(g, w)
    # decode_attend reads the updated cache without writing it
    _close(TATT.decode_attend(_t(q), *got[1:], _t(pos), chunk=16),
           JATT.decode_attend(jnp.asarray(q), *want[1:], jnp.asarray(pos),
                              chunk=16))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0],
                         ids=["drop_free", "with_drops"])
def test_moe_local(capacity_factor):
    cfg = jax_get_arch("deepseek-moe-16b").tiny()
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    rng = np.random.default_rng(3)
    D, E, F = cfg.d_model, mcfg.n_experts, mcfg.d_ff_expert
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    w_in = rng.standard_normal((E, D, 2, F)).astype(np.float32) * D ** -0.5
    w_out = rng.standard_normal((E, F, D)).astype(np.float32) * F ** -0.5
    tmcfg = dataclasses.replace(get_arch("deepseek-moe-16b").tiny().moe,
                                capacity_factor=capacity_factor)
    y, aux = TMOE._moe_local(_t(x), _t(router), _t(w_in), _t(w_out),
                             mcfg=tmcfg, act="silu", norm_topk=False)
    jy, jaux = JMOE._moe_local(*map(jnp.asarray, (x, router, w_in, w_out)),
                               mcfg=mcfg, act="silu", model_axis=None,
                               norm_topk=False)
    _close(y, jy)
    _close(aux, jaux)
    C = TMOE.capacity(64, tmcfg)
    top_e = TMOE.top_k(torch.softmax(_t(x).reshape(64, D) @ _t(router), -1),
                       mcfg.top_k)[1]
    counts = torch.bincount(top_e.reshape(-1), minlength=E)
    assert bool((counts > C).any()) == (capacity_factor == 1.0)


def test_top_k_breaks_ties_to_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = TMOE.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2], [0, 1]]
    _close(vals, jv)


def _cache_leaves(cache, n_cycles):
    """The port's cache as the reference's stacked layout, flattened."""
    out = []
    for part in ("prefix", "suffix"):
        for c in cache[part]:
            out += [c["k"], c["v"], c["slot_pos"]]
    for slot in cache["cycle"]:
        for key in ("k", "v", "slot_pos"):
            out.append(torch.stack([slot[i][key] for i in range(n_cycles)]))
    return out + [cache["pos"]]


def _jax_cache_leaves(cache):
    out = []
    for part in ("prefix", "suffix"):
        for c in cache[part]:
            out += [c["k"], c["v"], c["slot_pos"]]
    for slot in cache["cycle"]:
        out += [slot["k"], slot["v"], slot["slot_pos"]]
    return out + [cache["pos"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg = jax_get_arch(arch).tiny()
    cfg = get_arch(arch).tiny()
    jparams = _jax_init(jcfg, 0)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  cfg, device="cpu")
    jopt = JM.ModelOptions(dtype=jnp.float32, remat=False)
    opt = TM.ModelOptions(dtype=torch.float32)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    # jitted: the reference's eager op-by-op run compiles every op anew
    jprefill = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, jopt,
                                               cache_len=16))
    jdecode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg, jopt))
    jl, jc = jprefill(jparams, jnp.asarray(prompt, jnp.int32))
    tl, tc = TM.prefill(params, {"tokens": torch.as_tensor(prompt)}, cfg,
                        opt, cache_len=16)
    n_cycles = TM.layout(cfg).n_cycles
    _close(tl, jl)
    for g, w in zip(_cache_leaves(tc, n_cycles), _jax_cache_leaves(jc)):
        _close(g, w)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = TM.decode_step(params, tc, torch.as_tensor(tok.copy()), cfg,
                                opt)
        _close(tl, jl)
        for g, w in zip(_cache_leaves(tc, n_cycles), _jax_cache_leaves(jc)):
            _close(g, w)
