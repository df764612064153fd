"""The RG-LRU block and tiny recurrentgemma-2b: the port against the JAX
package, on the CPU, in f32.

The same numpy inputs and weights go through ``repro.models.rglru`` and
``repro_torch.models.rglru``: the gates, the log-depth prefill scan
(against the reference's ``associative_scan``, with and without a
carried state, S a power of two and not), the decode step and the whole
block, prefill and a run of decode steps, at 1e-5.  Then tiny
recurrentgemma-2b, cut to 8 layers so that the stack has 2 cycles of
(rec, rec, local) and a suffix of 2 ``rec`` layers as the published 26
layers do, through prefill and decode at 1e-4 (atol = rtol): logits and
every cache leaf, the local ring of min(16, 26) slots wrapped.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_attention import cache_leaves, run_both

from repro.configs.base import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import rglru as JRG
from repro_torch.configs.base import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import rglru as TRG

pytestmark = pytest.mark.torch

ATOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
D, DR, W = 32, 48, 4


def _t(x):
    return torch.as_tensor(np.array(x, copy=True))


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def block():
    """Reference-initialized block weights (random conv taps and biases,
    which the reference initializes to zero), as numpy."""
    p = jax.tree.map(np.asarray, JL.split_annotated(
        JRG.init_rglru_block(jax.random.PRNGKey(1), D, DR, W))[0])
    rng = np.random.default_rng(1)
    p["conv"] = {"w": rng.standard_normal((W, DR)).astype(np.float32) * 0.5,
                 "b": rng.standard_normal(DR).astype(np.float32) * 0.1}
    p["b_a"] = rng.standard_normal(DR).astype(np.float32) * 0.1
    p["b_x"] = rng.standard_normal(DR).astype(np.float32) * 0.1
    return p


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _tp(p):
    return jax.tree.map(_t, p)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan(block, S, carried):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, DR)).astype(np.float32)
    h0 = rng.standard_normal((2, DR)).astype(np.float32) if carried \
        else None
    want = JRG.rglru_scan(_jp(block), jnp.asarray(x),
                          None if h0 is None else jnp.asarray(h0))
    got = TRG.rglru_scan(_tp(block), _t(x), None if h0 is None else _t(h0))
    for g, w in zip(got, want):
        _close(g, w)
    ga, gb = TRG._gates(_tp(block), _t(x))
    wa, wb = JRG._gates(_jp(block), jnp.asarray(x))
    _close(ga, wa)
    _close(gb, wb)


def test_linear_scan_is_the_recurrence():
    """The log-depth scan equals the sequential recurrence h_t = a_t
    h_{t-1} + b_t, in float64, at lengths around powers of two."""
    rng = np.random.default_rng(0)
    for S in (1, 3, 4, 5, 31, 64, 100):
        a = rng.uniform(0.5, 1.0, (3, S, 5))
        b = rng.standard_normal((3, S, 5))
        h, want = np.zeros((3, 5)), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = TRG.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


def test_rglru_block_prefill_then_steps(block):
    """The block's prefill (conv, scan, gate, output) and its decode steps
    continuing from the prefill's state, as the transformer's ``rec``
    branch builds the cache."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, D)).astype(np.float32)
    xs = rng.standard_normal((2, 4, D)).astype(np.float32)
    jy, jh = JRG.apply_rglru_block(_jp(block), jnp.asarray(x), "gelu")
    ty, th = TRG.apply_rglru_block(_tp(block), _t(x), "gelu")
    _close(ty, jy)
    _close(th, jh)
    jcache = {"h": jh, "conv": JL.apply_linear(
        {"w": jnp.asarray(block["in_rec"])}, jnp.asarray(x))[:, -(W - 1):]}
    tcache = {"h": th, "conv": TL.apply_linear(
        {"w": _t(block["in_rec"])}, _t(x))[:, -(W - 1):]}
    for t in range(xs.shape[1]):
        jy, jcache = JRG.apply_rglru_block_step(
            _jp(block), jnp.asarray(xs[:, t:t + 1]), jcache, "gelu")
        ty, tcache = TRG.apply_rglru_block_step(
            _tp(block), _t(xs[:, t:t + 1]), tcache, "gelu")
        _close(ty, jy)
        _close(tcache["h"], jcache["h"])
        _close(tcache["conv"], jcache["conv"])


def test_rglru_step_and_conv(block):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, DR)).astype(np.float32)
    h = rng.standard_normal((3, DR)).astype(np.float32)
    for g, w in zip(TRG.rglru_step(_tp(block), _t(x), _t(h)),
                    JRG.rglru_step(_jp(block), jnp.asarray(x),
                                   jnp.asarray(h))):
        _close(g, w)
    seq = rng.standard_normal((2, 9, DR)).astype(np.float32)
    _close(TL.apply_conv1d(_tp(block["conv"]), _t(seq)),
           JL.apply_conv1d(_jp(block["conv"]), jnp.asarray(seq)))
    buf = rng.standard_normal((2, W - 1, DR)).astype(np.float32)
    for g, w in zip(TL.conv1d_step(_tp(block["conv"]), _t(buf), _t(x[:2])),
                    JL.conv1d_step(_jp(block["conv"]), jnp.asarray(buf),
                                   jnp.asarray(x[:2]))):
        _close(g, w)


def test_lambda_init_range():
    """The port's own Lambda: a^c = exp(-c softplus(lam)) in (0.9,
    0.999), as the reference draws it."""
    lam = TRG.init_lambda(torch.Generator().manual_seed(0), 4096)
    a_c = torch.exp(-TRG.C_FACTOR * torch.nn.functional.softplus(lam))
    assert float(a_c.min()) >= 0.9 - 1e-6 and float(a_c.max()) <= 0.999 + 1e-6


# ---------------------------------------------------------------------------
# Tiny recurrentgemma-2b
# ---------------------------------------------------------------------------
def _tiny(get):
    return get("recurrentgemma-2b").tiny(n_layers=8)


@pytest.fixture(scope="module")
def griffin_pairs():
    cfg = _tiny(get_arch)
    return cfg, run_both(cfg, _tiny(jax_get_arch))


def test_recurrentgemma_config_and_layout_equal_reference():
    mine, ref = get_arch("recurrentgemma-2b"), jax_get_arch(
        "recurrentgemma-2b")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.d_rnn == ref.d_rnn == 2560
    for m, r in ((mine, ref), (_tiny(get_arch), _tiny(jax_get_arch))):
        assert dataclasses.asdict(m.tiny()) == dataclasses.asdict(r.tiny())
        assert TM.layout(m) == tuple(JM.layout(r))
    lay = TM.layout(mine)
    assert (lay.cycle, lay.n_cycles, lay.suffix) \
        == (("rec", "rec", "local"), 8, ("rec", "rec"))
    assert TM.layout(_tiny(get_arch)).suffix == ("rec", "rec")


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tiny_recurrentgemma_matches_reference(griffin_pairs, phase):
    """Logits and every cache leaf (the ``rec`` layers' state and conv
    buffer, the local ring), suffix layers included, at 1e-4."""
    cfg, pairs = griffin_pairs
    seen = 0
    for what, got, want in pairs:
        if what.startswith(phase):
            assert tuple(got.shape) == want.shape, what
            np.testing.assert_allclose(got.numpy(), want, err_msg=what,
                                       **TOL)
            seen += 1
    assert seen > 0
    cache = TM.init_cache(cfg, 1, 26, torch.float32)
    assert set(cache["suffix"][0]) == {"h", "conv"}
    assert cache["cycle"][2][0]["k"].shape[1] == cfg.window == 16


def test_recurrentgemma_cache_shapes_match_reference():
    cfg, jcfg = _tiny(get_arch), _tiny(jax_get_arch)
    n = TM.layout(cfg).n_cycles
    tc = TM.init_cache(cfg, 2, 40, torch.float32)
    jc = JM.init_cache(jcfg, 2, 40, jnp.float32)
    assert [tuple(x.shape) for x in cache_leaves(tc, n)] \
        == [x.shape for x in cache_leaves(jc)]
    assert [x.dtype for x in cache_leaves(tc, n)][:2] \
        == [torch.float32, torch.float32]
