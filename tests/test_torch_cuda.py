"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips with a reason without one.  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

Tolerance 0: indices, flags and the bits of every float (-0.0 and +0.0
differ) must be equal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as TREF
from repro_torch.kernels import sched_argmin as TK

pytestmark = [pytest.mark.torch, pytest.mark.cuda]

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else \
        x.to(torch.int64)


def _cases(name: str) -> dict:
    rng = np.random.default_rng(7)
    f32, i32 = np.float32, np.int32
    if name == "masked_argmin":
        cases = {f"random {s}": ((rng.integers(0, 6, s) * 0.5).astype(f32),
                                 rng.random(s) < 0.6)
                 for s in ((64, 1, 32), (5, 33, 7), (3, 1, 1))}
        s = (4, 24, 4)
        one_masked = np.ones(s, bool)
        one_masked[:, 9, 2] = False
        z = np.zeros(s, f32)
        z[:, ::2] = -0.0
        cases.update({
            "empty mask": (rng.random(s).astype(f32), np.zeros(s, bool)),
            "+inf valid": (np.full(s, np.inf, f32), one_masked),
            "valid >= BIG": (np.full(s, 2e30, f32), one_masked),
            "-0.0/+0.0": (z, np.ones(s, bool))})
        return {k: (v, {}) for k, v in cases.items()}
    if name in ("fused_minmin", "fused_maxmin"):
        def inst(r, n, m, t):
            return ((rng.integers(0, 20, (r, m))).astype(f32),
                    rng.random((r, n)) < 0.5, rng.random((r, m)) < 0.7,
                    rng.integers(0, t, (r, n)).astype(i32),
                    (rng.integers(1, 9, (r, t, m)) * 0.5).astype(f32))
        cases = {f"random {s}": inst(*s)
                 for s in ((64, 1024, 32, 4), (5, 1000, 7, 3), (3, 1, 1, 1))}
        a, ib, rm, tid, e = inst(4, 40, 6, 3)
        big = e.copy()
        big[:, 0], big[:, 1] = 2e30, np.inf
        cases.update({
            "empty batch": (a, np.zeros_like(ib), rm, tid, e),
            "no room": (a, ib, np.zeros_like(rm), tid, e),
            "all ties": (np.zeros_like(a), np.ones_like(ib),
                         np.ones_like(rm), tid, np.ones_like(e)),
            ">= BIG and +inf": (a, ib, rm, tid, big),
            "-0.0/+0.0": (np.full_like(a, -0.0), ib, rm, tid,
                          np.zeros_like(e))})
        if name == "fused_maxmin":
            signed = np.zeros_like(e)
            signed[..., ::2] = -0.0
            one_b, one_r = np.zeros_like(ib), np.zeros_like(rm)
            one_b[:, 5], one_r[:, 2] = True, True
            mixed_b, mixed_r = ib.copy(), rm.copy()
            mixed_b[0], mixed_r[1], mixed_r[2] = False, False, True
            cases.update({
                "-0.0 row minima": (np.full_like(a, -0.0), ib,
                                    np.ones_like(rm), tid, signed),
                "one valid pair": (a, one_b, one_r, tid, e),
                "mixed empty and full replicas": (a, mixed_b, mixed_r, tid,
                                                  e),
                "scores below -BIG": (np.full_like(a, -np.inf), ib, rm, tid,
                                      e)})
        return {k: (v, {}) for k, v in cases.items()}
    if name == "fused_start_pick":
        cases = {}
        for r, n, m in ((64, 1024, 32), (5, 1000, 7), (3, 1, 1)):
            cases[f"random {r}x{n}x{m}"] = (
                rng.integers(0, 8, (r, n)).astype(i32),
                rng.integers(-1, m + 1, (r, n)).astype(i32),
                rng.integers(-1000, 1 << 20, (r, n)).astype(i32), m)
        seq = rng.integers(0, 1 << 20, (4, 64)).astype(i32)
        seq[:, 5:] = 2**31 - 1
        cases["INT_MAX seqs"] = (rng.integers(1, 4, (4, 64)).astype(i32),
                                 rng.integers(0, 5, (4, 64)).astype(i32),
                                 seq, 5)
        return {k: (v, {"in_mq": 2}) for k, v in cases.items()}
    kw = {"not_arrived": 0, "live_lo": 1, "live_hi": 3}
    cases = {}
    for r, n in ((64, 1024), (5, 1000), (3, 1)):
        cases[f"random {r}x{n}"] = (rng.integers(0, 8, (r, n)).astype(i32),
                                    rng.uniform(0, 100, (r, n)).astype(f32),
                                    rng.uniform(0, 200, (r, n)).astype(f32))
    z = np.zeros((4, 50), f32)
    z[:, 1::3] = -0.0
    cases["empty (+inf)"] = (np.full((4, 50), 7, i32), z, z)
    cases["-0.0/+0.0 and +inf"] = (rng.integers(0, 4, (4, 50)).astype(i32),
                                   z, np.full((4, 50), np.inf, f32))
    return {k: (v, kw) for k, v in cases.items()}


@pytest.mark.parametrize("name", TK.NAMES)
def test_cuda_kernel_matches_plain(cuda_device, name):
    kernel = getattr(TK, name)
    plain = getattr(TREF, name + "_ref")
    for case, (args, kw) in _cases(name).items():
        args = [torch.from_numpy(a).to(cuda_device)
                if isinstance(a, np.ndarray) else a for a in args]
        before = TK.launches[name]
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert TK.launches[name] == before + 1, case
        want = plain(*args, **kw)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w)), f"{name} {case}"


def test_cuda_wrappers_reject_wrong_dtypes(cuda_device):
    status = torch.zeros((2, 8), dtype=torch.int64, device=cuda_device)
    arrival = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="status"):
        TK.fused_event_bounds(status, arrival, arrival)


def test_cuda_default_path_launches_every_kernel(cuda_device):
    """``run_experiment`` with default settings goes through all five
    kernels on the card and matches the CPU run bit for bit."""
    from repro_torch.launch import experiment as TX
    spec = TX.ExperimentSpec(20, TX.FleetAxis(4), TX.WorkloadAxis(48),
                             policy=TX.PolicyAxis(POLICIES), seed=5)
    _launches_all_and_matches_cpu(TX, spec, cuda_device)


def test_cuda_scenario_path_launches_every_kernel(cuda_device):
    """The same with a ``ScenarioAxis``: failures, spot kills, DVFS."""
    from repro_torch.launch import experiment as TX
    spec = TX.ExperimentSpec(
        40, TX.FleetAxis(4), TX.WorkloadAxis(48),
        scenario=TX.ScenarioAxis(fail_rates=(0.0, 0.3),
                                 dvfs_states=("powersave", "turbo"),
                                 spot_frac=0.5),
        policy=TX.PolicyAxis(POLICIES), seed=5)
    _launches_all_and_matches_cpu(TX, spec, cuda_device)


def _launches_all_and_matches_cpu(TX, spec, dev):
    TK.reset_launches()
    on_card = TX.run_experiment(spec, device=dev)
    torch.cuda.synchronize()
    assert all(TK.launches[name] > 0 for name in TK.NAMES), TK.launches
    on_cpu = TX.run_experiment(spec, device="cpu")
    for key, col in on_cpu.metrics.items():
        assert torch.equal(_bits(on_card.metrics[key]), _bits(col)), key
