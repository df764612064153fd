"""The port's grouped-matmul wrapper on the CPU against the JAX package.

On the CPU the wrapper runs its plain version (the masked einsum).  The
same numpy inputs go through it, through the Pallas kernel in interpret
mode (``repro.kernels.ops.grouped_matmul(..., interpret=True)``) and
through its jnp oracle (``repro.kernels.ref.grouped_matmul_ref``), on the
cases of ``tests/test_kernels.py``.  Tolerance: atol = 2e-5 * D and
rtol = 2e-5 in f32, 2e-2 * D and 2e-2 in bf16, the reference's own;
rows at or past a group's size must be exactly 0.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import grouped_matmul as TGMM

pytestmark = pytest.mark.torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x, dtype):
    j = jnp.asarray(x).astype(JDT[dtype])
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _check(dtype, lhs, rhs, sizes, **blocks):
    (jl, tl), (jr, tr) = _both(lhs, dtype), _both(rhs, dtype)
    got = TGMM.grouped_matmul(tl, tr, torch.as_tensor(sizes), **blocks)
    assert got.dtype == TDT[dtype]
    assert got.shape == (lhs.shape[0], lhs.shape[1], rhs.shape[2])
    got = got.float().numpy()
    d = lhs.shape[2]
    js = jnp.asarray(sizes, jnp.int32)
    for want in (ops.grouped_matmul(jl, jr, js, **blocks, interpret=True),
                 ref.grouped_matmul_ref(jl, jr, js)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL[dtype] * d, rtol=TOL[dtype])
    pad = np.arange(lhs.shape[1])[None, :] >= np.asarray(sizes)[:, None]
    assert (got[pad] == 0).all()
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,c,d,f,bc,bf", [
    (4, 40, 96, 72, 16, 32),
    (8, 128, 64, 128, 64, 64),
    (2, 16, 256, 512, 16, 128),
    (3, 33, 48, 40, 16, 16),    # ragged
])
def test_grouped_matmul_matches_reference(dtype, g, c, d, f, bc, bf):
    rng = np.random.default_rng(g * c)
    lhs = rng.standard_normal((g, c, d)).astype(np.float32)
    rhs = rng.standard_normal((g, d, f)).astype(np.float32)
    sizes = rng.integers(0, c + 1, g).astype(np.int32)
    _check(dtype, lhs, rhs, sizes, block_c=bc, block_f=bf)


def test_grouped_matmul_sizes_zero_partial_full():
    rng = np.random.default_rng(5)
    lhs = rng.standard_normal((4, 24, 40)).astype(np.float32)
    rhs = rng.standard_normal((4, 40, 36)).astype(np.float32)
    sizes = np.array([0, 7, 24, 1], np.int32)
    got = _check("float32", lhs, rhs, sizes, block_c=8, block_f=16)
    assert (got[0] == 0).all() and (got[2] != 0).any()


def test_grouped_matmul_all_empty_groups():
    lhs = np.ones((4, 32, 16), np.float32)
    rhs = np.ones((4, 16, 24), np.float32)
    got = _check("float32", lhs, rhs, np.zeros(4, np.int32), block_c=16,
                 block_f=24)
    assert float(np.abs(got).max()) == 0.0


def test_grouped_matmul_rejects_bad_inputs():
    lhs, rhs = torch.zeros(2, 4, 8), torch.zeros(2, 8, 3)
    sizes = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        TGMM.grouped_matmul(lhs.half(), rhs.half(), sizes)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        TGMM.grouped_matmul(lhs, rhs.bfloat16(), sizes)
    with pytest.raises(ValueError, match="int32 or int64"):
        TGMM.grouped_matmul(lhs, rhs, sizes.float())
    with pytest.raises(ValueError, match="shapes do not match"):
        TGMM.grouped_matmul(lhs, torch.zeros(2, 9, 3), sizes)
