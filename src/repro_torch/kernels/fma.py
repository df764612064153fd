"""Wrapper of the CUDA multiply-add kernel of the learned policies.

``fma(x, w, acc)`` is float32 ``x * w + acc`` rounded once, over operands
that broadcast to one shape of at most four dimensions.  The learned
forward pass (``core/neural.py``) sums every score as chains and lanes of
such steps, in the association orders of XLA's CPU dot on the
reference's shapes, where XLA fuses each step into one multiply-add.  No
Pallas kernel computes it in the reference: this kernel exists so that
each step is one launch on the card with the reference's single
rounding (``csrc/fma.cu``).

A tensor on the CPU goes to ``ref.fma_ref`` (``reduce.fma``, exact); a
CUDA tensor launches the kernel (building it on first use) or raises —
there is no fallback.  ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.sched_argmin import _on_cuda, _stream

NAMES = ("fma",)
MAX_DIMS = 4
# the kernel indexes in 32 bits: the element count and every operand's
# largest offset, plus one grid-stride step (at most 132 x 16 blocks of
# 256 threads), must stay below 2^31 (``csrc/fma.cu`` refuses the rest)
MAX_INDEX = 2**31 - 1 - 132 * 16 * 256

launches = dict.fromkeys(NAMES, 0)
# (shape, stride) of the three operands -> (output shape, Geom): the
# forward pass calls the wrapper with a few dozen layouts, thousands of
# times each, and working the geometry out costs more host time than
# the launch
_geometries: dict = {}


def reset_launches() -> None:
    for name in NAMES:
        launches[name] = 0


def geometry(shape: torch.Size, *operands: torch.Tensor) -> build.FmaGeom:
    """The kernel's ``Geom``: ``shape`` padded to four axes and each
    operand's element strides broadcast to it (0 on broadcast axes)."""
    pad = MAX_DIMS - len(shape)
    g = build.FmaGeom()
    g.n = shape.numel()
    g.shape[:] = [1] * pad + list(shape)
    for field, t in zip(("sx", "sw", "sa"), operands):
        getattr(g, field)[:] = [0] * pad + list(t.expand(shape).stride())
    return g


def check_fits(g: build.FmaGeom) -> None:
    """Raise unless the kernel's 32-bit indices reach every element and
    offset of ``g`` (at most ``MAX_INDEX``)."""
    offsets = [sum((n - 1) * s for n, s in zip(g.shape, getattr(g, f)))
               for f in ("sx", "sw", "sa")]
    if max([g.n] + offsets) > MAX_INDEX:
        raise ValueError(f"fma: {g.n} elements with largest operand "
                         f"offset {max(offsets)} exceed the kernel's 32-bit "
                         f"indices (at most {MAX_INDEX})")


def fma(x: torch.Tensor, w: torch.Tensor, acc: torch.Tensor
        ) -> torch.Tensor:
    """float32 ``x * w + acc`` rounded once; the operands broadcast to
    the output's shape (at most four dimensions, and on the card fewer
    than ``MAX_INDEX`` elements and operand offsets)."""
    for name, t in (("x", x), ("w", w), ("acc", acc)):
        if t.dtype != torch.float32:
            raise ValueError(f"fma: {name} must be float32, got {t.dtype}")
    if not _on_cuda(x, w, acc):
        return ref.fma_ref(x, w, acc)
    key = (x.shape, x.stride(), w.shape, w.stride(), acc.shape,
           acc.stride())
    hit = _geometries.get(key)
    if hit is None:
        shape = torch.broadcast_shapes(x.shape, w.shape, acc.shape)
        if len(shape) > MAX_DIMS:
            raise ValueError(f"fma: at most {MAX_DIMS} dimensions, got "
                             f"{tuple(shape)}")
        geom = geometry(shape, x, w, acc)
        check_fits(geom)
        hit = _geometries[key] = (shape, geom)
    shape, geom = hit
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel():
        build.check(build.load("fma").e2c_fma(
            x.data_ptr(), w.data_ptr(), acc.data_ptr(), out.data_ptr(),
            geom, _stream(x)), "fma", "fma")
        launches["fma"] += 1
    return out
