"""CPU models of the reduction orders of ``masked_argmin``,
``fused_minmin``, ``fused_maxmin`` and ``fused_start_pick`` in
``repro_torch/kernels/csrc/sched_argmin.cu``.

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
  same two-step reduction on complemented keys;
* ``fused_minmin``: the same per-type phase keeping the winning cell's
  own bits (+0.0 for a row [+0.0, -0.0]), the same scan as an argmin
  over (value, task * M + machine), out-of-batch tasks at (BIG, task *
  M), and the CTA's argmin in the two-step reduction;
* ``fused_start_pick``: the layout the wrapper picks (a warp per replica,
  the lanes over the statuses in groups of 4 or 1, or a 256-thread CTA),
  each task visited once, machine and seq read only for queued tasks, a
  running per-machine minimum of the 64-bit (seq, id) key (machines
  outside [0, M) in a spare entry; the order in which a lane's queued
  tasks reach the table does not change a minimum), then pick 0 where
  the least seq is INT_MAX or nothing is queued: such a column holds
  INT_MAX in every row, so its first row is its argmin.

A small property test draws R, N, M, T (M > 32, T = 1, T > N and N = 1
included) and values from {-0.0, +0.0, halves, 2e30, +-inf}, empty batches
and replicas without room, and statuses, machines (-1 to M) and seqs
(INT_MAX and negative ones among them).  ``tests/test_torch_cuda.py``
holds the kernels themselves to the plain versions on the card.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis optional (dev extra)
from test_torch_kernels_ref import ARGMIN, BN, FUSED, MAXMIN, PICK, _same, _t

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


def _scan(cells, value, ok, payload, better, init, index=None):
    """Each thread's in-order scan.  ``cells`` (P, K): thread p's cell
    indices in its scan order, -1 past its end; ``value``/``ok``/
    ``payload`` (and ``index``, the cell index by default) map cell
    indices (P,) to (R, P) tensors.  -> per-thread (value, index,
    payload, any) of shape (R, P)."""
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
        idx = j[None, :] if index is None else index(jj)
        take = live & better(x, idx, bv, bi)
        bv = torch.where(take, x, bv)
        bi = torch.where(take, idx, bi)
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


def _cta_best(bv, bi, bm, largest):
    """``block_best``: each warp's redux pair, then warp 0's over the
    warps' results, lanes past the last warp at (-+inf, INT_MAX, 0)."""
    r = bv.shape[0]
    parts = _redux(bv.reshape(r, -1, WARP), bi.reshape(r, -1, WARP),
                   bm.reshape(r, -1, WARP), largest)
    pad = WARP - parts[0].shape[1]
    fill = (float("-inf") if largest else float("inf"), INT_MAX, 0)
    return _redux(*[torch.cat([x, torch.full((r, pad), f, dtype=x.dtype)], 1)
                    for x, f in zip(parts, fill)], largest)


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


def type_minima_model(avail, room, eet_m, signed_zero):
    """Phase (a) of the per-type layout: per type, a warp whose lane l
    scans machines l, l + 32, ..., then the redux pair -> (minimum (R, T)
    f32, machine (R, T) i64).  The minimum keeps the winning cell's own
    bits (Min-Min); with ``signed_zero`` (Max-Min) a zero minimum is -0.0
    where a cell is -0.0, else +0.0."""
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
    if signed_zero:
        neg_zero = ((flat == 0) & torch.signbit(flat)).any(1)
        v = torch.where(v == 0, torch.where(neg_zero, -0.0, 0.0), v)
    return v.reshape(r, t), mach.reshape(r, t)


def _task_cells(n, threads, per):
    """(threads, K) task indices of each thread's scan: groups of ``per``
    consecutive tasks, the groups strided over the threads, -1 past N."""
    groups = -(-n // per)
    rounds = -(-groups // threads)
    g = torch.arange(threads)[:, None] + threads * torch.arange(rounds)
    tasks = (per * g[:, :, None] + torch.arange(per)).reshape(threads, -1)
    return torch.where(tasks < n, tasks, -1)


def fused_maxmin_model(avail, in_batch, room, type_id, eet_m):
    """``fused_maxmin`` in the per-type layout's order -> (task i32,
    machine i32, score f32)."""
    tmin, tmach = type_minima_model(avail, room, eet_m, signed_zero=True)
    n = in_batch.shape[1]
    tid = type_id.long()
    score = torch.where(in_batch, tmin.gather(1, tid), -BIG)
    mach = torch.where(in_batch, tmach.gather(1, tid), 0)
    # 4 tasks a thread (16-byte loads) where n % 4 == 0, else 1
    tasks = _task_cells(n, THREADS, 4 if n % 4 == 0 else 1)
    bv, bi, bm, _ = _scan(tasks, lambda j: score[:, j],
                          lambda j: in_batch[:, j], lambda j: mach[:, j],
                          _argmax_better, float("-inf"))
    bv, bi, bm = _cta_best(bv, bi, bm, largest=True)
    found = in_batch.any(1) & room.any(1)
    return (torch.where(found, bi, -1).to(torch.int32),
            torch.where(found, bm, -1).to(torch.int32),
            torch.where(found, bv, -BIG))


def fused_minmin_model(avail, in_batch, room, type_id, eet_m):
    """``fused_minmin`` in the per-type layout's order -> (flat idx i32,
    min f32): an argmin over (value, task * M + machine), a task outside
    the batch at (BIG, task * M)."""
    m = avail.shape[1]
    tmin, tmach = type_minima_model(avail, room, eet_m, signed_zero=False)
    n = in_batch.shape[1]
    tid = type_id.long()
    value = torch.where(in_batch, tmin.gather(1, tid), BIG)
    flat = m * torch.arange(n) + torch.where(in_batch, tmach.gather(1, tid),
                                             0)
    tasks = _task_cells(n, THREADS, 4 if n % 4 == 0 else 1)
    bv, bi, _, _ = _scan(tasks, lambda j: value[:, j],
                         lambda j: in_batch[:, j],
                         lambda j: torch.zeros_like(flat[:, j]),
                         _argmin_better, float("inf"),
                         index=lambda j: flat[:, j])
    bv, bi, _ = _cta_best(bv, bi, torch.zeros_like(bi), largest=False)
    found = in_batch.any(1) & room.any(1)
    return (torch.where(found, bi, -1).to(torch.int32),
            torch.where(found, bv, BIG))


NO_TASK = 2**63 - 1    # the kernel's empty key (all ones), as signed int64


def fused_start_pick_model(status, machine, seq, n_machines, *, in_mq=2):
    """``fused_start_pick`` in the kernel's order -> (pick i32, has bool).
    The 64-bit key ((seq ^ 0x80000000) << 32 | id) is ordered as the
    signed seq * 2**32 + id, which fits an int64."""
    r, n = status.shape
    m = n_machines
    layout = TK.pick_layout(n, m, status.data_ptr())
    if layout == 0:
        cells = _task_cells(n, THREADS, 1)
    else:
        cells = _task_cells(n, WARP, 4 if layout == 2 else 1)
    # every task once, by one thread
    seen = cells[cells >= 0]
    assert torch.equal(seen.sort().values, torch.arange(n))
    best = torch.full((r, m + 1), NO_TASK, dtype=torch.int64)
    for k in range(cells.shape[1]):
        j = cells[:, k]
        jj = j.clamp(min=0)
        queued = (j >= 0)[None, :] & (status[:, jj] == in_mq)
        # machine and seq of a queued task only: the rest read as 0
        mc = torch.where(queued, machine[:, jj], 0).long()
        sq = torch.where(queued, seq[:, jj], 0).long()
        # a machine outside [0, M) goes to the spare entry M
        slot = torch.where(queued & (mc >= 0) & (mc < m), mc, m)
        key = torch.where(queued, sq * 2**32 + jj[None, :], NO_TASK)
        best.scatter_reduce_(1, slot, key, "amin")
    best = best[:, :m]
    pick = torch.where(best >> 32 == INT_MAX, 0, best & 0xFFFFFFFF)
    return pick.to(torch.int32), best != NO_TASK


def _np(out):
    return [o.numpy() for o in out]


def _minmin_cases():
    """The FUSED cases, and the shapes and values only the per-type
    Min-Min order reaches."""
    cases = dict(FUSED)
    rng = np.random.default_rng(5)

    def inst(r, n, m, t):
        return (rng.integers(0, 20, (r, m)).astype(np.float32),
                rng.random((r, n)) < 0.5, rng.random((r, m)) < 0.7,
                rng.integers(0, t, (r, n)).astype(np.int32),
                (rng.integers(1, 9, (r, t, m)) * 0.5).astype(np.float32))
    # completions +0.0, -0.0, ... along every type row: the first, +0.0
    # on machine 0, wins (Max-Min's row minimum would be -0.0)
    avail, inb, room, tid, eet = FUSED["random 3x24x4"]
    pm = np.zeros_like(eet)
    pm[..., 1::2] = -0.0
    cases["type row [+0.0, -0.0]"] = (np.full_like(avail, -0.0), inb,
                                      np.ones_like(room), tid, pm)
    cases["T > N"] = inst(3, 5, 6, 9)
    cases["M > 32"] = inst(3, 24, 70, 3)
    cases["N % 4 != 0"] = inst(3, 1001, 5, 4)
    return cases


def _pick_cases():
    """The PICK cases, and the ones the warp layout's gate reaches."""
    cases = dict(PICK)
    rng = np.random.default_rng(6)
    r, n, m = 3, 40, 5
    st = rng.integers(0, 4, (r, n)).astype(np.int32)
    cases["every task queued on one machine"] = (
        np.full((r, n), 2, np.int32), np.full((r, n), 3, np.int32),
        rng.integers(-50, 50, (r, n)).astype(np.int32), m)
    seq = rng.integers(-5, 5, (r, n)).astype(np.int32)
    seq[:, ::3] = INT_MAX
    seq[0] = INT_MAX                     # replica 0: every queued seq
    cases["INT_MAX and negative seqs"] = (
        st, rng.integers(0, m, (r, n)).astype(np.int32), seq, m)
    cases["machines -1 and M"] = (
        np.full((r, n), 2, np.int32),
        rng.choice(np.array([-1, m, 1], np.int32), (r, n)),
        rng.integers(0, 9, (r, n)).astype(np.int32), m)
    cases["M > 32"] = (st, rng.integers(-1, 71, (r, n)).astype(np.int32),
                       rng.integers(0, 9, (r, n)).astype(np.int32), 70)
    cases["N % 4 != 0"] = (rng.integers(0, 4, (r, 301)).astype(np.int32),
                           rng.integers(-1, m + 1, (r, 301)).astype(np.int32),
                           rng.integers(0, 9, (r, 301)).astype(np.int32), m)
    return cases


MINMIN = _minmin_cases()
PICKS = _pick_cases()


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


@pytest.mark.parametrize("case", list(MINMIN))
def test_fused_minmin_model_matches_reference(case):
    args = MINMIN[case]
    got = _np(fused_minmin_model(*map(_t, args)))
    _same(got, _np(TREF.fused_minmin_ref(*map(_t, args))), f"plain {case}")
    _same(got, jax.vmap(JREF.fused_minmin_ref)(*args), f"oracle {case}")
    _same(got, jax.vmap(lambda *a: JK.fused_minmin(
        *a, block_n=BN, interpret=True))(*args), f"pallas {case}")


@pytest.mark.parametrize("case", list(PICKS))
def test_fused_start_pick_model_matches_reference(case):
    status, machine, seq, m = PICKS[case]
    got = _np(fused_start_pick_model(_t(status), _t(machine), _t(seq), m))
    _same(got, _np(TREF.fused_start_pick_ref(_t(status), _t(machine),
                                             _t(seq), m)), f"plain {case}")
    _same(got, jax.vmap(lambda s, mc, q: JREF.fused_start_pick_ref(
        s, mc, q, m, in_mq=2))(status, machine, seq), f"oracle {case}")
    _same(got, jax.vmap(lambda s, mc, q: JK.fused_start_pick(
        s, mc, q, m, in_mq=2, block_n=BN, interpret=True))(
        status, machine, seq), f"pallas {case}")


def test_start_pick_needs_machine_and_seq_of_queued_tasks_only():
    """The warp layout loads machine and seq for queued tasks only: the
    plain version's answer does not change when every other task's
    machine and seq are overwritten."""
    status, machine, seq, m = PICK["random 2x301x5"]
    queued = status == 2
    rng = np.random.default_rng(8)
    machine2 = np.where(queued, machine, rng.integers(-1, m + 1,
                                                      machine.shape))
    seq2 = np.where(queued, seq, rng.integers(-9, 9, seq.shape))
    want = _np(TREF.fused_start_pick_ref(_t(status), _t(machine), _t(seq), m))
    _same(_np(TREF.fused_start_pick_ref(_t(status), _t(machine2.astype(
        np.int32)), _t(seq2.astype(np.int32)), m)), want, "plain")
    _same(_np(fused_start_pick_model(_t(status), _t(machine), _t(seq), m)),
          want, "model")


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
    rows a warp per replica with 16-byte loads, Min-Min's and Max-Min's
    1024 tasks of 4 types the per-type layout (T > N the per-task one),
    the start pick's 1024 tasks on 32 machines a warp per replica with
    16-byte loads (more machines than 767 a CTA per replica)."""
    assert TK.argmin_layout(32, 0, 0) == 2
    assert TK.argmin_layout(33, 0, 0) == 1
    assert TK.argmin_layout(32, 4, 0) == 1           # unaligned rows
    assert TK.argmin_layout(TK.ARGMIN_WARP_MAX, 0, 0) == 2
    assert TK.argmin_layout(TK.ARGMIN_WARP_MAX + 1, 0, 0) == 0
    assert TK.type_layout(1024, 4, 0, 0) == 2
    assert TK.type_layout(1022, 4, 0, 0) == 1
    assert TK.type_layout(1024, 4, 4, 0) == 1        # unaligned type_id
    assert TK.type_layout(1024, 4, 0, 1) == 1        # unaligned in_batch
    assert TK.type_layout(7, 9, 0, 0) == 0           # T > N
    assert TK.type_layout(10**5, TK.TYPE_TABLE_MAX, 0, 0) == 2
    assert TK.type_layout(10**5, TK.TYPE_TABLE_MAX + 1, 0, 0) == 0
    # the table and block_best's 3 x 32 x 4 static bytes fit in the 48 KB
    # a launch gets without opting in to more
    assert TK.TYPE_TABLE_MAX * 8 + 3 * 32 * 4 <= 48 * 1024
    assert TK.pick_layout(1024, 32, 0) == 2
    assert TK.pick_layout(1001, 32, 0) == 1
    assert TK.pick_layout(1024, 32, 4) == 1          # unaligned status
    assert TK.pick_layout(1024, TK.PICK_WARP_MAX, 0) == 2
    assert TK.pick_layout(1024, TK.PICK_WARP_MAX + 1, 0) == 0
    # 8 warps' tables of M + 1 64-bit keys in 48 KB
    assert 8 * (TK.PICK_WARP_MAX + 1) * 8 == 48 * 1024


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
    got = fused_minmin_model(*map(_t, args))
    _same(_np(got), _np(TREF.fused_minmin_ref(*map(_t, args))),
          "fused_minmin")
    seq = rng.choice(np.array([INT_MAX, -3, 0, 1, 2], np.int32), (r, n))
    pick = (rng.integers(0, 4, (r, n)).astype(np.int32),
            rng.integers(-1, m + 1, (r, n)).astype(np.int32), seq)
    got = fused_start_pick_model(*map(_t, pick), m)
    _same(_np(got), _np(TREF.fused_start_pick_ref(*map(_t, pick), m)),
          "fused_start_pick")
