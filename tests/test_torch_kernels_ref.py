"""The port's kernel plain versions against the reference's kernels.

Each plain PyTorch version in ``repro_torch/kernels/ref.py`` is batched
over replicas; every replica's result must equal, bit for bit (tolerance
0), both the reference's jnp oracle (``repro/kernels/ref.py``) and its
Pallas kernel run in interpret mode, as ``tests/test_kernels_differential
.py`` runs it — on random inputs, ragged task counts, N=1, ties, -0.0/+0.0,
+inf, valid cells >= 1e30, empty masks and, for Max-Min, one valid pair
and a batch mixing empty and full replicas.  The kernel wrappers take the
plain path for CPU tensors.

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
holds each one against its plain version there.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.kernels import sched_argmin as JK
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import sched_argmin as TK

pytestmark = pytest.mark.torch

BN = 8    # Pallas block size: small, so ragged tails and multi-block carry


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _same(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=what)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# inputs: (R, ...) numpy batches
# ---------------------------------------------------------------------------
def _argmin_inputs():
    """Random shapes (ragged, N=1) plus edge cases on the first shape."""
    rng = np.random.default_rng(0)
    cases = {}
    for r, n, m in ((4, 24, 4), (2, 33, 3), (3, 1, 1)):
        vals = (rng.integers(0, 6, (r, n, m)) * 0.5).astype(np.float32)
        cases[f"random {r}x{n}x{m}"] = (vals, rng.random((r, n, m)) < 0.6)
    shape = (4, 24, 4)
    ones = np.ones(shape, bool)
    cases["empty mask"] = (rng.standard_normal(shape).astype(np.float32),
                           np.zeros(shape, bool))
    one_masked = ones.copy()
    one_masked[:, 9, 2] = False
    cases["+inf valid loses to masked BIG"] = (
        np.full(shape, np.inf, np.float32), one_masked)
    cases["valid cells >= BIG"] = (np.full(shape, 2e30, np.float32),
                                   one_masked)
    z = np.zeros(shape, np.float32)
    z[:, ::2] = -0.0
    z[1, 0, 0] = 0.0
    cases["-0.0/+0.0 ties"] = (z, ones)
    neg = np.ones(shape, np.float32)
    neg[:, 13, 1] = -np.inf
    cases["-inf wins"] = (neg, ones)
    return cases


def _fused_inputs():
    rng = np.random.default_rng(1)
    cases = {}
    for r, n, m, t in ((3, 24, 4, 3), (2, 33, 6, 5), (2, 1, 1, 1)):
        cases[f"random {r}x{n}x{m}"] = (
            rng.uniform(0, 20, (r, m)).astype(np.float32),
            rng.random((r, n)) < 0.5, rng.random((r, m)) < 0.7,
            rng.integers(0, t, (r, n)).astype(np.int32),
            rng.uniform(0.1, 9.0, (r, t, m)).astype(np.float32))
    avail, inb, room, tid, eet = cases["random 3x24x4"]
    cases["empty batch"] = (avail, np.zeros_like(inb), room, tid, eet)
    cases["no room"] = (avail, inb, np.zeros_like(room), tid, eet)
    cases["all ties"] = (np.zeros_like(avail), np.ones_like(inb),
                         np.ones_like(room), np.zeros_like(tid),
                         np.ones_like(eet))
    big = eet.copy()
    big[:, 0] = 2e30
    big[:, 1] = np.inf
    cases["completions >= BIG and +inf"] = (avail, inb, room, tid, big)
    cases["-0.0/+0.0"] = (np.full_like(avail, -0.0), inb, room, tid,
                          np.zeros_like(eet))
    return cases


def _maxmin_inputs():
    """The Min-Min cases, plus the cases only Max-Min's two-level
    reduction reaches."""
    cases = dict(FUSED)
    rng = np.random.default_rng(4)
    avail, inb, room, tid, eet = cases["random 3x24x4"]
    one_b = np.zeros_like(inb)
    one_b[:, 5] = True
    one_r = np.zeros_like(room)
    one_r[:, 2] = True
    cases["one valid pair"] = (avail, one_b, one_r, tid, eet)
    mixed_b, mixed_r = inb.copy(), room.copy()
    mixed_b[0] = False                   # replica 0: empty batch
    mixed_r[1] = False                   # replica 1: no room
    mixed_r[2] = True                    # replica 2: every machine
    cases["mixed empty and full replicas"] = (avail, mixed_b, mixed_r, tid,
                                              eet)
    cases["tied row minima"] = (
        np.zeros_like(avail), rng.random(inb.shape) < 0.7, room, tid,
        np.tile(np.arange(1, 5, dtype=np.float32), (3, 3, 1)))
    cases["scores below -BIG"] = (np.full_like(avail, -np.inf), inb, room,
                                  tid, eet)
    return cases


def _pick_inputs():
    rng = np.random.default_rng(2)
    cases = {}
    for r, n, m in ((3, 16, 4), (2, 301, 5), (2, 1, 1)):
        cases[f"random {r}x{n}x{m}"] = (
            rng.integers(0, 8, (r, n)).astype(np.int32),
            rng.integers(-1, m + 1, (r, n)).astype(np.int32),
            rng.integers(0, 1 << 20, (r, n)).astype(np.int32), m)
    mc = rng.integers(0, 4, (3, 16)).astype(np.int32)
    cases["equal seqs"] = (np.full((3, 16), 2, np.int32), mc,
                           np.full((3, 16), 7, np.int32), 4)
    seq = rng.integers(0, 1 << 20, (3, 16)).astype(np.int32)
    seq[:, 5:] = 2**31 - 1
    cases["INT_MAX seqs"] = (rng.integers(1, 4, (3, 16)).astype(np.int32),
                             mc, seq, 4)
    return cases


def _bounds_inputs():
    rng = np.random.default_rng(3)
    cases = {}
    for r, n in ((3, 16), (2, 301), (2, 1)):
        cases[f"random {r}x{n}"] = (
            rng.integers(0, 8, (r, n)).astype(np.int32),
            rng.uniform(0, 100, (r, n)).astype(np.float32),
            rng.uniform(0, 200, (r, n)).astype(np.float32))
    cases["empty (+inf)"] = (np.full((3, 16), 7, np.int32),
                             rng.random((3, 16)).astype(np.float32),
                             rng.random((3, 16)).astype(np.float32))
    z = np.zeros((3, 16), np.float32)
    z[:, 1::3] = -0.0
    cases["-0.0/+0.0 and +inf"] = (
        rng.integers(0, 4, (3, 16)).astype(np.int32), z,
        np.full((3, 16), np.inf, np.float32))
    return cases


ARGMIN = _argmin_inputs()
FUSED = _fused_inputs()
MAXMIN = _maxmin_inputs()
PICK = _pick_inputs()
BOUNDS = _bounds_inputs()
EB_KW = {"not_arrived": 0, "live_lo": 1, "live_hi": 3}


# ---------------------------------------------------------------------------
# plain versions vs the reference (jnp oracle and Pallas interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(ARGMIN))
def test_masked_argmin_matches_reference(case):
    vals, mask = ARGMIN[case]
    got = TK.masked_argmin(_t(vals), _t(mask))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    oracle = jax.vmap(JREF.masked_argmin_ref)(vals, mask)
    pallas = jax.vmap(lambda v, m: JK.masked_argmin(
        v, m, block_n=BN, interpret=True))(vals, mask)
    _same([g.numpy() for g in got], oracle, f"oracle {case}")
    _same([g.numpy() for g in got], pallas, f"pallas {case}")


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_minmin_matches_reference(case):
    args = FUSED[case]
    got = TK.fused_minmin(*map(_t, args))
    oracle = jax.vmap(JREF.fused_minmin_ref)(*args)
    pallas = jax.vmap(lambda *a: JK.fused_minmin(
        *a, block_n=BN, interpret=True))(*args)
    _same([g.numpy() for g in got], oracle, f"oracle {case}")
    _same([g.numpy() for g in got], pallas, f"pallas {case}")


@pytest.mark.parametrize("case", list(MAXMIN))
def test_fused_maxmin_matches_reference(case):
    args = MAXMIN[case]
    got = TK.fused_maxmin(*map(_t, args))
    assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                      torch.float32]
    oracle = jax.vmap(JREF.fused_maxmin_ref)(*args)
    pallas = jax.vmap(lambda *a: JK.fused_maxmin(
        *a, block_n=BN, interpret=True))(*args)
    _same([g.numpy() for g in got], oracle, f"oracle {case}")
    _same([g.numpy() for g in got], pallas, f"pallas {case}")


def test_reference_maxmin_signed_zero_fault():
    """Queue C fault, on the reference side: on a row whose completions
    mix -0.0 and +0.0 (avail -0.0, EET entries of both signs; the engine
    never produces such rows, its completions are positive), the Pallas
    ``fused_maxmin`` in interpret mode returns the row minimum +0.0 where
    its jnp oracle returns -0.0, as XLA's ``min`` orders -0.0 below
    +0.0.  The port follows the oracle."""
    eet = np.zeros((1, 1, 4), np.float32)
    eet[..., ::2] = -0.0
    args = (np.full((1, 4), -0.0, np.float32), np.ones((1, 3), bool),
            np.ones((1, 4), bool), np.zeros((1, 3), np.int32), eet)
    oracle = jax.vmap(JREF.fused_maxmin_ref)(*args)
    pallas = jax.vmap(lambda *a: JK.fused_maxmin(
        *a, block_n=BN, interpret=True))(*args)
    assert np.signbit(np.asarray(oracle[2])).all()
    assert not np.signbit(np.asarray(pallas[2])).any()
    got = TK.fused_maxmin(*map(_t, args))
    _same([g.numpy() for g in got], oracle, "oracle")


@pytest.mark.parametrize("case", list(PICK))
def test_fused_start_pick_matches_reference(case):
    status, machine, seq, m = PICK[case]
    got = TK.fused_start_pick(_t(status), _t(machine), _t(seq), m, in_mq=2)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    oracle = jax.vmap(lambda s, mc, q: JREF.fused_start_pick_ref(
        s, mc, q, m, in_mq=2))(status, machine, seq)
    pallas = jax.vmap(lambda s, mc, q: JK.fused_start_pick(
        s, mc, q, m, in_mq=2, block_n=BN, interpret=True))(
        status, machine, seq)
    _same([g.numpy() for g in got], oracle, f"oracle {case}")
    _same([g.numpy() for g in got], pallas, f"pallas {case}")


@pytest.mark.parametrize("case", list(BOUNDS))
def test_fused_event_bounds_matches_reference(case):
    status, arrival, deadline = BOUNDS[case]
    got = TK.fused_event_bounds(_t(status), _t(arrival), _t(deadline),
                                **EB_KW)
    oracle = jax.vmap(lambda *a: JREF.fused_event_bounds_ref(*a, **EB_KW))(
        status, arrival, deadline)
    pallas = jax.vmap(lambda *a: JK.fused_event_bounds(
        *a, block_n=BN, interpret=True, **EB_KW))(status, arrival, deadline)
    _same([g.numpy() for g in got], oracle, f"oracle {case}")
    _same([g.numpy() for g in got], pallas, f"pallas {case}")


CPU_CALLS = {
    "masked_argmin": (ARGMIN["random 4x24x4"], {}),
    "fused_minmin": (FUSED["random 3x24x4"], {}),
    "fused_maxmin": (MAXMIN["mixed empty and full replicas"], {}),
    "fused_start_pick": (PICK["random 2x301x5"], {"in_mq": 2}),
    "fused_event_bounds": (BOUNDS["random 2x301"], EB_KW),
}


@pytest.mark.parametrize("name", TK.NAMES)
def test_wrappers_route_cpu_to_plain_uncounted(name):
    """On CPU tensors each wrapper returns its plain version's result,
    and the launch counters, which count kernel launches only, stay."""
    args, kw = CPU_CALLS[name]
    args = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    before = dict(TK.launches)
    got = getattr(TK, name)(*args, **kw)
    want = getattr(TREF, name + "_ref")(*args, **kw)
    assert TK.launches == before
    _same([g.numpy() for g in got], [w.numpy() for w in want], name)


def test_wrappers_reject_mixed_devices():
    vals, mask = ARGMIN["random 4x24x4"]
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        TK.masked_argmin(_t(vals), _t(mask).to("meta"))
