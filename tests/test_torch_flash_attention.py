"""The port's flash-attention wrapper on the CPU against the JAX package.

On the CPU the wrapper runs its plain version (the dense masked
softmax).  The same numpy inputs go through it, through the Pallas
kernel in interpret mode (``repro.kernels.ops.flash_attention(...,
interpret=True)``) and through its jnp oracle
(``repro.kernels.ref.flash_attention_ref``), on the cases of
``tests/test_kernels.py`` plus rows with no visible key.  Tolerance
atol = rtol = 2e-5 in f32 and 2e-2 in bf16, the reference's own
(``tests/test_kernels.py``); the bf16 inputs are the same bf16 values on
both sides.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as TFA

pytestmark = pytest.mark.torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype, scale=1.0):
    """numpy f32 draws, rounded to ``dtype`` once, handed to both sides."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in shapes:
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        * scale).astype(JDT[dtype])
        js.append(x)
        ts.append(torch.as_tensor(np.array(x.astype(jnp.float32)))
                  .to(TDT[dtype]))
    return js, ts


def _check(dtype, jargs, targs, **kw):
    blocks = {k: kw.pop(k) for k in ("block_q", "block_k") if k in kw}
    got = TFA.flash_attention(*targs, **kw, **blocks)
    assert got.dtype == TDT[dtype] and got.shape == targs[0].shape
    got = got.float().numpy()
    pallas = ops.flash_attention(*jargs, **kw, **blocks, interpret=True)
    oracle = ref.flash_attention_ref(*jargs, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,hd,bq,bk", [
    (128, 128, 64, 64, 64),
    (130, 130, 64, 64, 64),     # ragged: padding correctness
    (64, 256, 128, 64, 128),    # cross-attention shape (sq != sk)
    (37, 53, 16, 16, 32),       # odd everything
    (256, 256, 256, 128, 128),  # gemma3 head_dim
])
def test_flash_attention_causal(dtype, sq, sk, hd, bq, bk):
    jargs, targs = _inputs(0, [(3, sq, hd), (3, sk, hd), (3, sk, hd)],
                           dtype)
    _check(dtype, jargs, targs, causal=sq == sk, block_q=bq, block_k=bk)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_flash_attention_sliding_window(window):
    jargs, targs = _inputs(1, [(2, 192, 32)] * 3, "float32")
    _check("float32", jargs, targs, causal=True, window=window, block_q=64,
           block_k=64)


def test_flash_attention_softcap():
    jargs, targs = _inputs(2, [(2, 64, 32)] * 3, "float32", scale=3.0)
    _check("float32", jargs, targs, causal=True, softcap=20.0, block_q=32,
           block_k=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_rows_with_no_visible_key(dtype):
    """Sq > Sk with a window: queries at or past Sk + window - 1 see no
    key and come out exactly 0."""
    sq, sk, window = 96, 32, 16
    jargs, targs = _inputs(3, [(2, sq, 32), (2, sk, 32), (2, sk, 32)],
                           dtype)
    got = _check(dtype, jargs, targs, causal=True, window=window,
                 block_q=32, block_k=32)
    dead = sk + window - 1
    assert not TFA.visible_mask(sq, sk, causal=True,
                                window=window)[dead:].any()
    assert (got[:, dead:] == 0).all() and (got[:, :dead] != 0).any()


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        TFA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        TFA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="shapes do not match"):
        TFA.flash_attention(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    with pytest.raises(ValueError, match="head width"):
        big = torch.zeros(1, 4, 512)
        TFA.flash_attention(big, big, big)
    with pytest.raises(ValueError, match=r"\(BH, S, hd\)"):
        TFA.flash_attention(q[None], q[None], q[None])
