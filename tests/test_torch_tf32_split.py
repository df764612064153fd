"""Why the model kernels multiply f32 as 3xTF32: an emulation on the CPU.

The CUDA flash attention and grouped matmul run their f32 products on
the tensor cores, which take TF32 operands (10 of f32's 23 mantissa
bits).  One TF32 product per f32 product (single pass) misses the f32
tolerance of the kernels' contract; splitting each operand into a TF32
``big`` and the rest ``small`` = x - big and summing big*big + big*small
+ small*big (3xTF32, ``csrc/tensor_core.cuh``) meets it.  This file
emulates both on the CPU as the kernels compute them: ``big`` rounded
to nearest with ties away (the kernels' integer add and mask, the bits
of ``cvt.rna.tf32.f32``), ``small`` truncated to TF32 as the tensor core
reads it, exact products of TF32 values in f32, f32 sums, at the main
path's widths, against the port's plain versions:

* flash attention at hd 64, 128 and 256, causal, windowed, softcapped,
  S up to 1024, atol = rtol = 2e-5;
* the grouped matmul at deepseek-moe-16b's two expert shapes (D 2048 x
  F 2816 and D 1408 x F 2048; few groups and rows), atol = 2e-5 * D,
  rtol = 2e-5.

3xTF32 must stay within and single-pass TF32 outside those tolerances,
so that the kernels do not drop to single-pass TF32.  Inputs are
standard normal, made with numpy from fixed seeds, as the chip check's
kernel cases are.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import NEG, flash_attention_ref
from repro_torch.kernels.flash_attention import visible_mask
from repro_torch.kernels.grouped_matmul import grouped_matmul_ref

pytestmark = pytest.mark.torch

F32_TOL = 2e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest with ties away from zero (the
    kernels' ``big``): add half a TF32 unit to the bit pattern and clear
    the 13 low mantissa bits."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return u.view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from an f32 operand: its 13
    low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) as the tensor core reads them."""
    big = tf32(x)
    return big, truncate(x - big)


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: single-pass TF32 (``passes``
    1) or 3xTF32 (3), the small cross terms first."""
    (ab, a_small), (bb, b_small) = split(a), split(b)
    if passes == 1:
        return ab @ bb
    return a_small @ bb + ab @ b_small + ab @ bb


def flash_emulated(q, k, v, *, causal, window, softcap, passes):
    """The plain flash attention with both products emulated."""
    hd = q.shape[-1]
    s = matmul(q, k.transpose(1, 2), passes) * hd ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = visible_mask(q.shape[1], k.shape[1], causal=causal,
                        window=window)
    p = torch.where(mask, torch.softmax(torch.where(mask, s, NEG), -1), 0.0)
    return matmul(p, v, passes)


def worst(got, want, atol, rtol) -> tuple[float, str]:
    """Largest |got - want| / (atol + rtol |want|) (<= 1 is within), and
    where it is."""
    ratio = (got - want).abs() / (atol + rtol * want.abs())
    i = int(ratio.argmax())
    at = tuple(int(x) for x in np.unravel_index(i, ratio.shape))
    return float(ratio.flatten()[i]), (f"at {at}: {float(got.flatten()[i])} "
                                       f"vs {float(want.flatten()[i])}")


def _normal(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 unit at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0e-3, -7.25e5], dtype=torch.float32)
    got = tf32(x)
    assert got[:4].tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((got - x).abs() <= x.abs() * 2.0 ** -11).all())


def test_split_keeps_21_bits():
    rng = np.random.default_rng(0)
    x = _normal(rng, 4096) * torch.from_numpy(
        np.exp2(rng.integers(-20, 20, 4096)).astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - big).abs() <= x.abs() * 2.0 ** -11).all())
    rest = (x.double() - big.double() - small.double()).abs()
    assert bool((rest <= x.double().abs() * 2.0 ** -21).all())
    assert bool(((x - big).abs() > x.abs() * 2.0 ** -16).any())


@pytest.mark.parametrize("bh,s,hd,causal,window,softcap", [
    (2, 1024, 128, True, 0, 0.0),        # the serving path's prefill
    (1, 512, 64, True, 0, 0.0),
    (1, 1024, 256, True, 0, 0.0),
    (2, 512, 128, True, 128, 0.0),
    (1, 512, 128, True, 0, 30.0),
    (2, 256, 64, False, 0, 0.0),
    (1, 384, 256, False, 100, 20.0),
])
def test_flash_attention_needs_3xtf32(bh, s, hd, causal, window, softcap):
    rng = np.random.default_rng(s + hd + window)
    q, k, v = (_normal(rng, bh, s, hd) for _ in range(3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_ref(q, k, v, **kw)
    three, at3 = worst(flash_emulated(q, k, v, **kw, passes=3), want,
                       F32_TOL, F32_TOL)
    single, at1 = worst(flash_emulated(q, k, v, **kw, passes=1), want,
                        F32_TOL, F32_TOL)
    assert three <= 1.0, f"3xTF32 at {three:.3g}x the f32 tolerance {at3}"
    assert single > 1.0, f"single-pass TF32 within tolerance ({single:.3g})"


@pytest.mark.parametrize("d,f", [(2048, 2816), (1408, 2048)],
                         ids=["w_in", "w_out"])
def test_grouped_matmul_needs_3xtf32(d, f):
    rng = np.random.default_rng(d)
    g, c = 2, 8
    lhs, rhs = _normal(rng, g, c, d), _normal(rng, g, d, f)
    sizes = torch.tensor([c, c - 3], dtype=torch.int32)
    want = grouped_matmul_ref(lhs, rhs, sizes)
    valid = (torch.arange(c)[None, :] < sizes[:, None])[..., None]
    masked = torch.where(valid, lhs, 0.0)
    for passes, within in ((3, True), (1, False)):
        got = torch.where(valid, matmul(masked, rhs, passes), 0.0)
        ratio, at = worst(got, want, F32_TOL * d, F32_TOL)
        assert (ratio <= 1.0) == within, \
            f"{passes} pass(es): {ratio:.3g}x the f32 tolerance {at}"
