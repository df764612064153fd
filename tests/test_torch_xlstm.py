"""The xLSTM blocks and tiny xlstm-350m: the port against the JAX package,
on the CPU, in f32.

The same numpy inputs and weights go through ``repro.models.xlstm`` and
``repro_torch.models.xlstm``: the mLSTM parallel form, its decode step
and the prefill cache (the port's closed form against the reference's
scan, ``transformer._mlstm_prefill_cache``), the sLSTM cell, its
sequential scan and step, and both blocks through prefill and a run of
decode steps, at 1e-5.  Then tiny xlstm-350m (two cycles of (mlstm,
mlstm, mlstm, slstm)) through prefill and 4 decode steps at 1e-4 (atol =
rtol): logits and every cache leaf.  The reference initializes conv taps
and biases to zero, which makes q and k of the mLSTM zero; the tests put
seeded noise on them.
"""
from __future__ import annotations

import dataclasses

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
from repro.models import xlstm as JXL
from repro_torch.configs.base import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TXL

pytestmark = pytest.mark.torch

# the reference's functions jitted (eager, its scans compile every call)
J_MSTEP = jax.jit(JXL.apply_mlstm_block_step, static_argnums=3)
J_SBLOCK = jax.jit(JXL.apply_slstm_block, static_argnums=2)
J_SSTEP = jax.jit(JXL.apply_slstm_block_step, static_argnums=3)
J_MCACHE = jax.jit(JT._mlstm_prefill_cache, static_argnums=2)
J_MBLOCK = jax.jit(JXL.apply_mlstm_block, static_argnums=2)
J_QKVIF = jax.jit(JXL._mlstm_qkvif)
J_PARALLEL = jax.jit(JXL.mlstm_parallel, static_argnums=5)
J_MCELL = jax.jit(JXL.mlstm_step, static_argnums=6)
J_SCELL = jax.jit(JXL.slstm_cell, static_argnums=3)

ATOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
D, H, W, PF = 32, 4, 4, 2.0
DI = int(D * PF)


def _t(x):
    return torch.as_tensor(np.array(x, copy=True))


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _tp(p):
    return jax.tree.map(_t, p)


def _noisy(p, rng):
    """Seeded noise on every all-zero leaf (conv taps, biases)."""
    return jax.tree.map(lambda a: a if a.any() else
                        (0.3 * rng.standard_normal(a.shape)).astype(a.dtype),
                        p)


@pytest.fixture(scope="module")
def mblock():
    p = jax.tree.map(np.asarray, jax.jit(lambda k: JL.split_annotated(
        JXL.init_mlstm_block(k, D, H, PF, W))[0])(jax.random.PRNGKey(1)))
    return _noisy(p, np.random.default_rng(1))


@pytest.fixture(scope="module")
def sblock():
    p = jax.tree.map(np.asarray, jax.jit(lambda k: JL.split_annotated(
        JXL.init_slstm_block(k, D, H, W))[0])(jax.random.PRNGKey(2)))
    return _noisy(p, np.random.default_rng(2))


@pytest.mark.parametrize("S", [1, 5, 24])
def test_mlstm_parallel_form(mblock, S):
    x = np.random.default_rng(S).standard_normal((2, S, DI)).astype(
        np.float32)
    tq = TXL._mlstm_qkvif(_tp(mblock), _t(x))
    jq = J_QKVIF(_jp(mblock), jnp.asarray(x))
    for g, w in zip(tq, jq):
        _close(g, w)
    th, (tm, tF) = TXL.mlstm_parallel(*tq, H)
    jh, (jm, jF) = J_PARALLEL(*jq, H)
    for g, w in ((th, jh), (tm, jm), (tF, jF)):
        _close(g, w)


@pytest.mark.parametrize("S", [1, 3, 24])
def test_mlstm_prefill_cache_closed_form(mblock, S):
    """The closed-form (C, n, m) against the reference's scan of rank-1
    updates, and the conv buffer."""
    cfg = dataclasses.replace(jax_get_arch("xlstm-350m").tiny(),
                              d_model=D, n_heads=H, conv_width=W)
    h = np.random.default_rng(10 + S).standard_normal((2, S, D)).astype(
        np.float32)
    _, got = TXL.apply_mlstm_block(_tp(mblock), _t(h), H)
    want = J_MCACHE(_jp(mblock), jnp.asarray(h), cfg)
    assert set(got) == set(want) == {"C", "n", "m", "conv"}
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key], want[key])


def test_mlstm_step(mblock):
    rng = np.random.default_rng(3)
    dh = DI // H
    q, k, v = (rng.standard_normal((2, DI)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((2, H)).astype(np.float32)
    lf = -np.abs(rng.standard_normal((2, H))).astype(np.float32)
    cache = {"C": rng.standard_normal((2, H, dh, dh)).astype(np.float32),
             "n": rng.standard_normal((2, H, dh)).astype(np.float32),
             "m": np.array([[0.5, -1.0, 2.0, -1e30]] * 2, np.float32)}
    th, tc = TXL.mlstm_step(*map(_t, (q, k, v, li, lf)), _tp(cache), H)
    jh, jc = J_MCELL(*map(jnp.asarray, (q, k, v, li, lf)), _jp(cache), H)
    _close(th, jh)
    for key in jc:
        _close(tc[key], jc[key])


def test_mlstm_block_prefill_then_decode(mblock):
    """The block's prefill output and cache, then 5 decode steps from
    that cache, against the reference's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    y, cache = TXL.apply_mlstm_block(_tp(mblock), _t(x), H)
    _close(y, J_MBLOCK(_jp(mblock), jnp.asarray(x), H))
    cfg = dataclasses.replace(jax_get_arch("xlstm-350m").tiny(),
                              d_model=D, n_heads=H, conv_width=W)
    jcache = J_MCACHE(_jp(mblock), jnp.asarray(x), cfg)
    for step in range(5):
        xt = rng.standard_normal((2, 1, D)).astype(np.float32)
        y, cache = TXL.apply_mlstm_block_step(_tp(mblock), _t(xt), cache, H)
        jy, jcache = J_MSTEP(_jp(mblock), jnp.asarray(xt), jcache, H)
        _close(y, jy)
        for key in jcache:
            _close(cache[key], jcache[key])


def test_slstm_cell(sblock):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, D)).astype(np.float32)
    state = [rng.standard_normal((3, D)).astype(np.float32) for _ in range(4)]
    state[2][0] = -1e30                             # a first step's m
    got = TXL.slstm_cell(_tp(sblock), _t(x), tuple(map(_t, state)), H)
    want = J_SCELL(_jp(sblock), jnp.asarray(x),
                   tuple(map(jnp.asarray, state)), H)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("S", [1, 7, 30])
def test_slstm_scan_and_step(sblock, S):
    """The block's sequential scan (output and final state) from the
    initial state and from a carried one, then decode steps."""
    rng = np.random.default_rng(20 + S)
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    y, state = TXL.apply_slstm_block(_tp(sblock), _t(x), H)
    jy, jstate = J_SBLOCK(_jp(sblock), jnp.asarray(x), H)
    _close(y, jy)
    for g, w in zip(state, jstate):
        _close(g, w)
    y2, state2 = TXL.apply_slstm_block(_tp(sblock), _t(x), H, state=state)
    jy2, jstate2 = J_SBLOCK(_jp(sblock), jnp.asarray(x), H, jstate)
    _close(y2, jy2)
    for g, w in zip(state2, jstate2):
        _close(g, w)
    buf = np.pad(x, ((0, 0), (W - 1, 0), (0, 0)))[:, -(W - 1):]
    cache = {"c": state[0], "n": state[1], "m": state[2], "h": state[3],
             "conv": _t(buf)}
    jcache = {"c": jstate[0], "n": jstate[1], "m": jstate[2],
              "h": jstate[3], "conv": jnp.asarray(buf)}
    for _ in range(3):
        xt = rng.standard_normal((2, 1, D)).astype(np.float32)
        y, cache = TXL.apply_slstm_block_step(_tp(sblock), _t(xt), cache, H)
        jy, jcache = J_SSTEP(_jp(sblock), jnp.asarray(xt), jcache, H)
        _close(y, jy)
        for key in jcache:
            _close(cache[key], jcache[key])


def test_group_norm_and_caches():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, DI)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(DI).astype(np.float32)
    _close(TL.group_norm(_t(x), H, _t(scale)),
           JL.group_norm(jnp.asarray(x), H, jnp.asarray(scale)))
    for got, want in (
            (TXL.init_mlstm_cache(2, D, H, PF, W, torch.float32),
             JXL.init_mlstm_cache(2, D, H, PF, W, jnp.float32)),
            (TXL.init_slstm_cache(2, D, W, torch.float32),
             JXL.init_slstm_cache(2, D, W, jnp.float32))):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])


# ---------------------------------------------------------------------------
# Tiny xlstm-350m
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def xlstm_pairs():
    cfg = get_arch("xlstm-350m").tiny()
    return cfg, run_both(cfg, jax_get_arch("xlstm-350m").tiny(),
                         prompt_len=19, n_decode=4, seed=3, jitter=0.1)


def test_xlstm_config_and_layout_equal_reference():
    mine, ref = get_arch("xlstm-350m"), jax_get_arch("xlstm-350m")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.tiny()) == dataclasses.asdict(ref.tiny())
    lay = TM.layout(mine)
    assert lay == tuple(JM.layout(ref))
    assert (lay.cycle, lay.n_cycles) == (("mlstm", "mlstm", "mlstm",
                                          "slstm"), 6)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tiny_xlstm_matches_reference(xlstm_pairs, phase):
    """Logits and every cache leaf (C, n, m, conv of the mLSTM layers; c,
    n, m, h, conv of the sLSTM ones) at 1e-4."""
    _, pairs = xlstm_pairs
    seen = 0
    for what, got, want in pairs:
        if what.startswith(phase):
            assert tuple(got.shape) == want.shape, what
            np.testing.assert_allclose(got.numpy(), want, err_msg=what,
                                       **TOL)
            seen += 1
    assert seen > 0


def test_xlstm_init_and_cache_shapes_match_reference():
    """The port's own initializer gives the reference's tree (keys and
    shapes; ``b_f_init`` and the per-head ``r_*`` included) and
    ``init_cache`` the reference's shapes and dtypes."""
    cfg = get_arch("xlstm-350m").tiny()
    jcfg = jax_get_arch("xlstm-350m").tiny()
    mine = TM.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                jcfg)[0])
    n = TM.layout(cfg).n_cycles
    for j, slot in enumerate(ref["stack"]["cycle"]):
        got = jax.tree.map(lambda a: (n,) + tuple(a.shape),
                           mine["stack"]["cycle"][j][0])
        assert got == jax.tree.map(lambda a: tuple(a.shape), slot)
    s_cell = mine["stack"]["cycle"][3][0]["cell"]
    dh = cfg.d_model // cfg.n_heads
    assert s_cell["r_f"].shape == (cfg.n_heads, dh, dh)
    torch.testing.assert_close(s_cell["b_f_init"],
                               torch.linspace(3.0, 6.0, cfg.d_model))
    tc = TM.init_cache(cfg, 2, 30, torch.float32)
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 30, jnp.float32))
    for j, slot in enumerate(jc["cycle"]):
        for key, leaf in slot.items():
            mine_leaf = tc["cycle"][j][0][key]
            assert (n,) + tuple(mine_leaf.shape) == leaf.shape, key
            assert str(mine_leaf.dtype).split(".")[-1] == str(leaf.dtype), \
                key
