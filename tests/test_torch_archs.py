"""Six of the port's ten configurations against the JAX package, on the
CPU, in f32.

Each of xlstm-350m, command-r-35b (parallel blocks, LayerNorm, tied
embeddings), qwen2-72b, qwen3-moe-235b-a22b (routed experts, QK-norm),
phi-3-vision-4.2b (text only, as the serving engine runs it) and
seamless-m4t-large-v2 (encoder-decoder, seeded frames) in its tiny form
goes through the JAX package's ``prefill`` and ``decode_step`` (jitted,
its own ``init_params`` weights with seeded noise on the zero-initialized
biases, conv taps and norm offsets) and the port's (the same weights,
``interop.lm_params_from_numpy``): logits and every cache leaf at 1e-4
(atol = rtol).  qwen3-moe's route is then held at its published expert
count, 128 experts and top-8 with normalized weights, at a 1024-token
prompt's capacity, with the grouped matmul's padding rows exactly 0.
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
from repro.configs.base import list_archs as jax_list_archs
from repro.kernels import ref as JKREF
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.kernels import grouped_matmul as GMM
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("xlstm-350m", "command-r-35b", "qwen2-72b", "qwen3-moe-235b-a22b",
         "phi-3-vision-4.2b", "seamless-m4t-large-v2")
PROMPT, DECODE, S_ENC = 20, 6, 24


def test_every_reference_config_is_ported():
    assert list_archs() == jax_list_archs()
    for name in list_archs():
        mine, ref = get_arch(name), jax_get_arch(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(mine.tiny()) == \
            dataclasses.asdict(ref.tiny()), name
        assert mine.kinds() == ref.kinds()
        assert TM.layout(mine) == tuple(JM.layout(ref))


@pytest.fixture(scope="module", params=ARCHS)
def arch_pairs(request):
    name = request.param
    cfg = get_arch(name).tiny()
    extra = None
    if cfg.is_encdec:
        extra = {"frames": np.random.default_rng(7).standard_normal(
            (2, S_ENC, cfg.d_model)).astype(np.float32)}
    return name, run_both(cfg, jax_get_arch(name).tiny(), PROMPT, DECODE,
                          extra=extra, jitter=0.1)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tiny_prefill_and_decode_match_reference(arch_pairs, phase):
    name, pairs = arch_pairs
    seen = 0
    for what, got, want in pairs:
        if what.startswith(phase):
            assert tuple(got.shape) == want.shape, (name, what)
            np.testing.assert_allclose(got.numpy(), want,
                                       err_msg=f"{name} {what}", **TOL)
            seen += 1
    assert seen > 0


def test_block_structure_matches_reference():
    """The port's own initializer gives each new configuration the
    reference's parameter tree (keys and shapes: LayerNorm biases, no
    ``ln2`` in command-r's parallel blocks, the plain MLP's ``bi``/``bo``
    in seamless, its ``encoder``, ``enc_norm``, ``ln_cross`` and
    ``cross``)."""
    for name in ARCHS:
        cfg, jcfg = get_arch(name).tiny(), jax_get_arch(name).tiny()
        mine = TM.init_params(torch.Generator().manual_seed(0), cfg)
        ref = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    jcfg)[0])
        assert set(mine) == set(ref), name
        for stack in ("stack", "encoder"):
            if stack not in ref:
                continue
            n = jax.tree.leaves(ref[stack]["cycle"][0])[0].shape[0]
            for j, slot in enumerate(ref[stack]["cycle"]):
                got = jax.tree.map(lambda a: (n,) + tuple(a.shape),
                                   mine[stack]["cycle"][j][0])
                assert got == jax.tree.map(lambda a: tuple(a.shape), slot), \
                    (name, stack)
    block = TM.init_params(torch.Generator().manual_seed(0),
                           get_arch("command-r-35b").tiny()
                           )["stack"]["cycle"][0][0]
    assert "ln2" not in block and set(block["ln1"]) == {"scale", "bias"}
    seam = TM.init_params(torch.Generator().manual_seed(0),
                          get_arch("seamless-m4t-large-v2").tiny())
    dec = seam["stack"]["cycle"][0][0]
    assert set(dec["mlp"]) == {"wi", "bi", "wo", "bo"}
    assert {"ln_cross", "cross"} <= set(dec)
    assert "qn" not in dec["cross"] and "bq" in dec["cross"]
    assert "cross" not in seam["encoder"]["cycle"][0][0]


# ---------------------------------------------------------------------------
# qwen3-moe's route at 128 experts
# ---------------------------------------------------------------------------
def test_qwen3_moe_route_at_128_experts():
    """128 experts, top-8, normalized top-k weights, no shared expert,
    1024 tokens (capacity 80, as at a 1024-token prompt), narrow widths:
    the port's ``_moe_local`` (the grouped matmul's plain version on the
    CPU) against the reference's."""
    jmcfg = jax_get_arch("qwen3-moe-235b-a22b").moe
    mcfg = get_arch("qwen3-moe-235b-a22b").moe
    assert (mcfg.n_experts, mcfg.top_k, mcfg.n_shared) == (128, 8, 0)
    assert TMOE.capacity(1024, mcfg) == JMOE.capacity(1024, jmcfg) == 80
    assert TMOE.capacity(1, mcfg) == JMOE.capacity(1, jmcfg) == 8
    jmcfg = dataclasses.replace(jmcfg, d_ff_expert=16)
    mcfg = dataclasses.replace(mcfg, d_ff_expert=16)
    rng = np.random.default_rng(11)
    D, E, F = 32, 128, 16
    x = rng.standard_normal((1, 1024, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    w_in = rng.standard_normal((E, D, 2, F)).astype(np.float32) * D ** -0.5
    w_out = rng.standard_normal((E, F, D)).astype(np.float32) * F ** -0.5
    t = [torch.as_tensor(a.copy()) for a in (x, router, w_in, w_out)]
    y, aux = TMOE._moe_local(*t, mcfg=mcfg, act="silu", norm_topk=True)
    jy, jaux = jax.jit(lambda *a: JMOE._moe_local(
        *a, mcfg=jmcfg, act="silu", model_axis=None, norm_topk=True))(
        *map(jnp.asarray, (x, router, w_in, w_out)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_grouped_matmul_at_128_groups_zero_padding_rows():
    """At G = 128 with the sizes of a decode step (8 live groups of one
    row) and of a ragged prefill, the wrapper's CPU path equals the
    reference's masked einsum and every row at or past a group's size
    is exactly 0."""
    rng = np.random.default_rng(12)
    for c, sizes in ((8, np.where(np.arange(128) % 16 == 3, 1, 0)),
                     (80, rng.integers(0, 81, 128))):
        lhs = rng.standard_normal((128, c, 24)).astype(np.float32)
        rhs = rng.standard_normal((128, 24, 20)).astype(np.float32)
        sz = sizes.astype(np.int32)
        got = GMM.grouped_matmul(torch.as_tensor(lhs), torch.as_tensor(rhs),
                                 torch.as_tensor(sz))
        want = JKREF.grouped_matmul_ref(jnp.asarray(lhs), jnp.asarray(rhs),
                                        jnp.asarray(sz))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pad = np.arange(c)[None, :] >= sz[:, None]
        assert (got.numpy()[pad] == 0).all()
