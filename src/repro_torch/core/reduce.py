"""Float operations whose results match the reference engine bit for bit.

Float addition is not associative, so a sum is only reproducible if its
association order is.  The reference runs on XLA, whose CPU compiler
rewrites every reduction over more than 32 elements into a tree: the
axis is zero-padded symmetrically to a multiple of 32, each window of 32
is summed left to right from 0, and the window sums are reduced the same
way, recursively.  ``ordered_sum`` reproduces that order with a fixed
sequence of elementwise adds, so it gives the same bits on the CPU and on
the card.  ``torch.sum`` reduces in an order of its own (and another on
the card), which differs in the last place for a few entries in a
thousand.

``signed_min``: XLA's ``min`` orders -0.0 below +0.0, while
``torch.amin`` returns whichever zero its reduction met first.

``fma``: XLA's CPU compiler contracts ``c + a * b`` into one fused
multiply-add (a single rounding), where PyTorch rounds the product and
the sum separately.  ``fma`` computes the single-rounding result exactly,
in float64 with round-to-odd, so it is the same on the CPU and the card.
"""
from __future__ import annotations

import torch

WINDOW = 32


def _sequential(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Left-to-right sum over ``dim``, starting from 0."""
    shape = x.shape[:dim] + x.shape[dim + 1:]
    acc = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in the reference's association order (see the
    module docstring).  Integer and bool inputs are exact in any order;
    pass them to ``torch.sum`` instead."""
    dim = dim % x.ndim
    n = x.shape[dim]
    if n <= WINDOW:
        return _sequential(x, dim)
    n_win = -(-n // WINDOW)
    pad = n_win * WINDOW - n
    if pad:
        def zeros(k):
            shape = list(x.shape)
            shape[dim] = k
            return x.new_zeros(shape)
        x = torch.cat([zeros(pad // 2), x, zeros(pad - pad // 2)], dim)
    windows = x.unflatten(dim, (n_win, WINDOW))
    return ordered_sum(_sequential(windows, dim + 1), dim)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once.  The float64 product of two
    float32 values is exact; the sum is rounded to odd (its rounding
    error from an exact two-sum decides the last bit), which makes the
    final rounding to float32 correct."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def signed_min(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``amin`` over ``dim`` with -0.0 ordered below +0.0 (XLA's order).
    NaNs are out of contract, as in the reference."""
    m = x.amin(dim)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim)
    zero = torch.where(neg_zero, -0.0, 0.0).to(m.dtype)
    return torch.where(m == 0, zero, m)
