"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips with a reason without one.  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

Tolerance 0 for the scheduling kernels: indices, flags and the bits of
every float (-0.0 and +0.0 differ) must be equal.  The model kernels
(flash attention, grouped matmul) sum in another order than their plain
versions: atol = rtol = 2e-5 (f32) and 2e-2 (bf16) for flash attention,
atol = 2e-5 * D and rtol = 2e-5 (f32), 2e-2 * D and 2e-2 (bf16) for the
grouped matmul, whose padding rows must be exactly 0.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import grouped_matmul as TGMM
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


MODEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(0)
    for bh, sq, sk, hd, kw in (
            (3, 128, 128, 64, {"causal": True}),
            (3, 130, 130, 128, {"causal": True}),
            (2, 64, 256, 128, {"causal": False}),
            (3, 37, 53, 16, {"causal": True}),
            (2, 256, 256, 256, {"causal": True}),
            (2, 192, 192, 32, {"causal": True, "window": 64}),
            (2, 64, 64, 32, {"causal": True, "softcap": 20.0}),
            (2, 96, 32, 32, {"causal": True, "window": 16})):
        q, k, v = (torch.randn(bh, s, hd, generator=g).to(cuda_device, dtype)
                   for s in (sq, sk, sk))
        before = TFA.launches["flash_attention"]
        got = TFA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert TFA.launches["flash_attention"] == before + 1
        want = TFA.flash_attention_ref(q, k, v, **kw)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=MODEL_TOL[dtype],
                                   rtol=MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_grouped_matmul_matches_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(1)
    for gr, c, d, f, sizes in (
            (4, 40, 96, 72, [0, 13, 40, 1]),
            (8, 128, 64, 128, [128, 0, 64, 65, 1, 127, 3, 0]),
            (3, 33, 48, 40, [33, 0, 17]),
            (6, 8, 2048, 200, [1, 0, 0, 1, 0, 1]),
            (4, 32, 16, 24, [0, 0, 0, 0])):
        lhs = torch.randn(gr, c, d, generator=g).to(cuda_device, dtype)
        rhs = torch.randn(gr, d, f, generator=g).to(cuda_device, dtype)
        sz = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
        got = TGMM.grouped_matmul(lhs, rhs, sz)
        torch.cuda.synchronize()
        want = TGMM.grouped_matmul_ref(lhs, rhs, sz)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=MODEL_TOL[dtype] * d,
                                   rtol=MODEL_TOL[dtype])
        pad = torch.arange(c, device=cuda_device)[None, :] >= sz[:, None]
        assert bool((got[pad] == 0).all())


def test_cuda_model_wrappers_reject_wrong_dtypes(cuda_device):
    q = torch.zeros((2, 8, 16), dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        TFA.flash_attention(q, q, q)
    lhs = torch.zeros((2, 4, 8), dtype=torch.float64, device=cuda_device)
    rhs = torch.zeros((2, 8, 3), dtype=torch.float64, device=cuda_device)
    sizes = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        TGMM.grouped_matmul(lhs, rhs, sizes)


def test_cuda_tiny_serving_launches_both_model_kernels(cuda_device):
    """A real-mode ``ServingEngine`` run with tiny qwen2-1.5b and tiny
    deepseek-moe-16b on the card prefills through flash attention and
    runs the MoE FFN through the grouped matmul."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.workload import poisson_workload
    from repro_torch.models import model as TM
    from repro_torch.serving import AppSpec, ServeConfig, ServingEngine
    gen = torch.Generator(cuda_device).manual_seed(0)
    cfgs = [get_arch(a).tiny() for a in ("qwen2-1.5b", "deepseek-moe-16b")]
    apps = [AppSpec(c.name, gen_len=4, arch=c,
                    params=TM.init_params(gen, c), prompt_len=8)
            for c in cfgs]
    eng = ServingEngine(np.array([[0.3, 0.6], [0.5, 0.4]], np.float32),
                        np.array([[50., 200.], [30., 120.]], np.float32),
                        [0, 1], apps, ServeConfig(policy="mct",
                                                  run_mode="real"),
                        device=cuda_device)
    wl = poisson_workload(5, rate=1.0, n_task_types=2, slack=10.0, seed=3)
    TFA.reset_launches()
    TGMM.reset_launches()
    rep = eng.run(wl)
    n = np.bincount(wl.type_id, minlength=2)
    assert rep.completed == 5
    assert TFA.launches["flash_attention"] == n[0] * cfgs[0].n_layers \
        + n[1] * cfgs[1].n_layers
    n_moe = cfgs[1].kinds().count("moe")
    assert TGMM.launches["grouped_matmul"] == n[1] * 2 * n_moe * (1 + 4)
