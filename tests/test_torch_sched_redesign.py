"""CPU models of the reduction orders of ``masked_argmin`` and
``fused_maxmin`` in ``repro_torch/kernels/csrc/sched_argmin.cu``.

The CUDA kernels run only on a card, so each model below follows its
kernel's order in plain PyTorch, and is held bit for bit (tolerance 0:
indices and the bits of every float, -0.0 and +0.0 differ) to the port's
plain versions (``kernels/ref.py``), the reference's jnp oracle and its
Pallas kernel in interpret mode:

* ``masked_argmin``: the layout the wrapper picks (a warp per replica,
  each lane a contiguous chunk, or a 256-thread CTA per replica with
  strided slices), each lane's in-order scan, then the shuffle tree at
  the kernel's lane count;
* ``fused_maxmin``: per-type minima (a warp per type, lanes over the
  machines in chunks of 32, the two-``redux.sync`` (key, machine)
  reduction, the -0.0 rule), then the task scan, 4 tasks a thread, with
  out-of-batch tasks at -BIG on machine 0, and the CTA's argmax in the
  same two-step reduction on complemented keys.

A small property test draws R, N, M, T (M > 32, T = 1, T > N and N = 1
included) and values from {-0.0, +0.0, halves, 2e30, +-inf}, empty batches
and replicas without room.  ``tests/test_torch_cuda.py`` holds the
kernels themselves to the plain versions on the card.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis optional (dev extra)
from test_torch_kernels_ref import ARGMIN, BN, MAXMIN, _same, _t

from repro.kernels import ref as JREF
from repro.kernels import sched_argmin as JK
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import sched_argmin as TK

pytestmark = pytest.mark.torch

BIG = TREF.BIG
INT_MAX = TREF.INT_MAX
WARP = 32
THREADS = 256     # the CTA of the per-replica layouts


def _argmin_better(v, i, bv, bi):
    return (v < bv) | ((v == bv) & (i < bi))


def _argmax_better(v, i, bv, bi):
    return (v > bv) | ((v == bv) & (i < bi))


def _scan(cells, value, ok, payload, better, init):
    """Each thread's in-order scan.  ``cells`` (P, K): thread p's cell
    indices in its scan order, -1 past its end; ``value``/``ok``/
    ``payload`` map cell indices (P,) to (R, P) tensors.  -> per-thread
    (value, index, payload, any) of shape (R, P)."""
    r = ok(cells[:, 0].clamp(min=0)).shape[0]
    p = cells.shape[0]
    bv = torch.full((r, p), init, dtype=torch.float32)
    bi = torch.full((r, p), INT_MAX, dtype=torch.int64)
    bm = torch.zeros((r, p), dtype=torch.int64)
    seen = torch.zeros((r, p), dtype=torch.bool)
    for k in range(cells.shape[1]):
        j = cells[:, k]
        jj = j.clamp(min=0)
        live = (j >= 0)[None, :]
        x = value(jj)
        take = live & better(x, j[None, :], bv, bi)
        bv = torch.where(take, x, bv)
        bi = torch.where(take, j[None, :], bi)
        bm = torch.where(take, payload(jj), bm)
        seen |= live & ok(jj)
    return bv, bi, bm, seen


def _tree(bv, bi, bm, better):
    """``__shfl_down_sync`` reduction over the last axis (32 lanes): a
    lane whose partner is past lane 31 reads its own value back.  ->
    lane 0's (value, index, payload)."""
    lanes = torch.arange(WARP)
    for off in (16, 8, 4, 2, 1):
        src = torch.where(lanes + off < WARP, lanes + off, lanes)
        ov, oi, om = bv[..., src], bi[..., src], bm[..., src]
        take = better(ov, oi, bv, bi)
        bv = torch.where(take, ov, bv)
        bi = torch.where(take, oi, bi)
        bm = torch.where(take, om, bm)
    return bv[..., 0], bi[..., 0], bm[..., 0]


def tie_key(x: torch.Tensor, largest: bool = False) -> torch.Tensor:
    """The kernels' order-preserving uint32 key (as int64), -0.0 and +0.0
    equal; complemented where the largest value wins."""
    u = torch.where(x == 0, 0.0, x).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    key = torch.where(u >= 2**31, ~u & 0xFFFFFFFF, u | 2**31)
    return ~key & 0xFFFFFFFF if largest else key


def _redux(bv, bi, bm, largest):
    """``warp_min_pair`` over the last axis (32 lanes): the least key,
    then the least index among the lanes holding it (two ``redux.sync``),
    the value's own bits and the payload from the first such lane."""
    key = tie_key(bv, largest)
    kmin = key.min(-1, keepdim=True).values
    imin = torch.where(key == kmin, bi, INT_MAX).min(-1, keepdim=True).values
    src = ((key == kmin) & (bi == imin)).to(torch.int8).argmax(-1,
                                                              keepdim=True)
    return (bv.gather(-1, src)[..., 0], imin[..., 0],
            bm.gather(-1, src)[..., 0])


def _cta_argmax(bv, bi, bm):
    """``block_argmax3``: each warp's redux pair, then warp 0's over the
    warps' results, lanes past the last warp at (-inf, INT_MAX, 0)."""
    r = bv.shape[0]
    parts = _redux(bv.reshape(r, -1, WARP), bi.reshape(r, -1, WARP),
                   bm.reshape(r, -1, WARP), largest=True)
    pad = WARP - parts[0].shape[1]
    fill = (float("-inf"), INT_MAX, 0)
    return _redux(*[torch.cat([x, torch.full((r, pad), f, dtype=x.dtype)], 1)
                    for x, f in zip(parts, fill)], largest=True)


def _cta_tree(bv, bi, bm, better, init):
    """A CTA's reduction: each warp's tree, then warp 0's tree over the
    warps' results, lanes past the last warp at (init, INT_MAX, 0)."""
    r = bv.shape[0]
    parts = _tree(bv.reshape(r, -1, WARP), bi.reshape(r, -1, WARP),
                  bm.reshape(r, -1, WARP), better)
    pad = WARP - parts[0].shape[1]
    fill = (init, INT_MAX, 0)
    return _tree(*[torch.cat([x, torch.full((r, pad), f, dtype=x.dtype)], 1)
                   for x, f in zip(parts, fill)], better)


def _cells(length, layout):
    """(P, K) cell indices of each thread's scan in ``masked_argmin``'s
    layout: a contiguous chunk a lane (whole float4s with 16-byte loads)
    or a strided slice a thread of the CTA."""
    if layout == 0:
        k = -(-length // THREADS)
        idx = torch.arange(THREADS)[:, None] + THREADS * torch.arange(k)
    else:
        chunk = -(-length // (4 * WARP)) * 4 if layout == 2 \
            else -(-length // WARP)
        idx = chunk * torch.arange(WARP)[:, None] + torch.arange(chunk)
    return torch.where(idx < length, idx, -1)


def masked_argmin_model(values, mask):
    """``masked_argmin`` in the kernel's order -> (idx i32, min f32)."""
    r = values.shape[0]
    v = values.reshape(r, -1).to(torch.float32).contiguous()
    mk = mask.reshape(r, -1).contiguous()
    length = v.shape[1]
    layout = TK.argmin_layout(length, v.data_ptr(), mk.data_ptr())
    bv, bi, bm, seen = _scan(
        _cells(length, layout), lambda j: torch.where(mk[:, j], v[:, j], BIG),
        lambda j: mk[:, j], lambda j: torch.zeros_like(v[:, j], dtype=int),
        _argmin_better, float("inf"))
    if layout == 0:
        bv, bi, _ = _cta_tree(bv, bi, bm, _argmin_better, float("inf"))
    else:
        bv, bi, _ = _tree(bv, bi, bm, _argmin_better)
    found = seen.any(1)
    return (torch.where(found, bi, -1).to(torch.int32),
            torch.where(found, bv, BIG))


def type_minima_model(avail, room, eet_m):
    """Phase (a) of the per-type layout: per type, a warp whose lane l
    scans machines l, l + 32, ..., then the redux pair -> (minimum (R, T)
    f32, machine (R, T) i64); a zero minimum is -0.0 where a cell is
    -0.0, else +0.0."""
    r, t, m = eet_m.shape
    comp = torch.where(room[:, None, :], avail[:, None, :] + eet_m, BIG)
    k = -(-m // WARP)
    cols = torch.arange(WARP)[:, None] + WARP * torch.arange(k)
    cols = torch.where(cols < m, cols, -1)
    flat = comp.reshape(r * t, m)
    bv, bi, bm, _ = _scan(cols, lambda j: flat[:, j],
                          lambda j: torch.ones_like(flat[:, j], dtype=bool),
                          lambda j: torch.zeros_like(flat[:, j], dtype=int),
                          _argmin_better, float("inf"))
    v, mach, _ = _redux(bv, bi, bm, largest=False)
    neg_zero = ((flat == 0) & torch.signbit(flat)).any(1)
    v = torch.where(v == 0, torch.where(neg_zero, -0.0, 0.0), v)
    return v.reshape(r, t), mach.reshape(r, t)


def fused_maxmin_model(avail, in_batch, room, type_id, eet_m):
    """``fused_maxmin`` in the per-type layout's order -> (task i32,
    machine i32, score f32)."""
    tmin, tmach = type_minima_model(avail, room, eet_m)
    n = in_batch.shape[1]
    tid = type_id.long()
    score = torch.where(in_batch, tmin.gather(1, tid), -BIG)
    mach = torch.where(in_batch, tmach.gather(1, tid), 0)
    # 4 tasks a thread (16-byte loads) where n % 4 == 0, else 1, the
    # threads' groups strided over the CTA
    per = 4 if n % 4 == 0 else 1
    groups = -(-n // per)
    rounds = -(-groups // THREADS)
    g = torch.arange(THREADS)[:, None] + THREADS * torch.arange(rounds)
    tasks = (per * g[:, :, None] + torch.arange(per)).reshape(THREADS, -1)
    tasks = torch.where(tasks < n, tasks, -1)
    bv, bi, bm, _ = _scan(tasks, lambda j: score[:, j],
                          lambda j: in_batch[:, j], lambda j: mach[:, j],
                          _argmax_better, float("-inf"))
    bv, bi, bm = _cta_argmax(bv, bi, bm)
    found = in_batch.any(1) & room.any(1)
    return (torch.where(found, bi, -1).to(torch.int32),
            torch.where(found, bm, -1).to(torch.int32),
            torch.where(found, bv, -BIG))


def _np(out):
    return [o.numpy() for o in out]


# ---------------------------------------------------------------------------
# the models on the reference cases: plain version, oracle, Pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(ARGMIN))
def test_masked_argmin_model_matches_reference(case):
    vals, mask = ARGMIN[case]
    got = _np(masked_argmin_model(_t(vals), _t(mask)))
    _same(got, _np(TREF.masked_argmin_ref(_t(vals), _t(mask))),
          f"plain {case}")
    _same(got, jax.vmap(JREF.masked_argmin_ref)(vals, mask), f"oracle {case}")
    _same(got, jax.vmap(lambda v, m: JK.masked_argmin(
        v, m, block_n=BN, interpret=True))(vals, mask), f"pallas {case}")


@pytest.mark.parametrize("case", list(MAXMIN))
def test_fused_maxmin_model_matches_reference(case):
    args = MAXMIN[case]
    got = _np(fused_maxmin_model(*map(_t, args)))
    _same(got, _np(TREF.fused_maxmin_ref(*map(_t, args))), f"plain {case}")
    _same(got, jax.vmap(JREF.fused_maxmin_ref)(*args), f"oracle {case}")
    _same(got, jax.vmap(lambda *a: JK.fused_maxmin(
        *a, block_n=BN, interpret=True))(*args), f"pallas {case}")


# ---------------------------------------------------------------------------
# the layouts each side of the wrappers' choices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(9, 1, 32), (3, 1, 7), (2, 31, 33),
                                   (2, 1, 1023), (2, 1, 1024),
                                   (2, 1, 1025), (2, 64, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_masked_argmin_model_each_layout(shape):
    """Either side of the warp/CTA threshold (1024 cells), 16-byte and
    plain loads: many duplicate minima, -0.0/+0.0, +inf and 2e30 cells,
    empty rows."""
    rng = np.random.default_rng(sum(shape))
    pool = np.array([-0.0, 0.0, 0.5, 1.0, 2e30, np.inf], np.float32)
    vals = rng.choice(pool, shape)
    mask = rng.random(shape) < 0.5
    mask[0] = False
    got = masked_argmin_model(_t(vals), _t(mask))
    _same(_np(got), _np(TREF.masked_argmin_ref(_t(vals), _t(mask))),
          f"{shape}")


def test_layout_choices():
    """The engine's shapes take the new layouts: the drain's (R, 1, 32)
    rows a warp per replica with 16-byte loads, Max-Min's 1024 tasks of 4
    types the per-type layout; T > N the per-task one."""
    assert TK.argmin_layout(32, 0, 0) == 2
    assert TK.argmin_layout(33, 0, 0) == 1
    assert TK.argmin_layout(32, 4, 0) == 1           # unaligned rows
    assert TK.argmin_layout(TK.ARGMIN_WARP_MAX, 0, 0) == 2
    assert TK.argmin_layout(TK.ARGMIN_WARP_MAX + 1, 0, 0) == 0
    assert TK.maxmin_layout(1024, 4, 0, 0) == 2
    assert TK.maxmin_layout(1022, 4, 0, 0) == 1
    assert TK.maxmin_layout(7, 9, 0, 0) == 0         # T > N
    assert TK.maxmin_layout(10**5, TK.TYPE_TABLE_MAX, 0, 0) == 2
    assert TK.maxmin_layout(10**5, TK.TYPE_TABLE_MAX + 1, 0, 0) == 0
    # the table and block_argmax3's 3 x 32 x 4 static bytes fit in the
    # 48 KB a launch gets without opting in to more
    assert TK.TYPE_TABLE_MAX * 8 + 3 * 32 * 4 <= 48 * 1024


# ---------------------------------------------------------------------------
# property: random shapes and values
# ---------------------------------------------------------------------------
POOL = np.array([-0.0, 0.0, 0.5, 1.0, 1.5, 2e30, np.inf, -np.inf],
                np.float32)
# EET entries stay finite, so no completion is inf - inf
EET_POOL = np.array([-0.0, 0.0, 0.5, 1.0, 2e30], np.float32)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(r=st.integers(1, 4), n=st.integers(1, 40), m=st.integers(1, 70),
       t=st.integers(1, 12), seed=st.integers(0, 2**31 - 1),
       empty=st.sampled_from(["none", "batch", "room"]))
def test_models_property(r, n, m, t, seed, empty):
    rng = np.random.default_rng(seed)
    vals = rng.choice(POOL, (r, n, m))
    mask = rng.random((r, n, m)) < rng.random()
    got = masked_argmin_model(_t(vals), _t(mask))
    _same(_np(got), _np(TREF.masked_argmin_ref(_t(vals), _t(mask))),
          "masked_argmin")
    args = (rng.choice(POOL, (r, m)), rng.random((r, n)) < rng.random(),
            rng.random((r, m)) < rng.random(),
            rng.integers(0, t, (r, n)).astype(np.int32),
            rng.choice(EET_POOL, (r, t, m)))
    if empty != "none":     # replica 0: no task waiting, or no room
        args[1 if empty == "batch" else 2][0] = False
    got = fused_maxmin_model(*map(_t, args))
    _same(_np(got), _np(TREF.fused_maxmin_ref(*map(_t, args))),
          "fused_maxmin")
