"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips with a reason without one.  The file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

Tolerance 0 for the scheduling kernels: indices, flags and the bits of
every float (-0.0 and +0.0 differ) must be equal, and each case is
launched twice with bitwise-equal results; the cases cover both layouts
of ``masked_argmin``, ``fused_minmin``, ``fused_maxmin`` and
``fused_start_pick``.  The model kernels
(flash attention, grouped matmul) sum in another order than their plain
versions: atol = rtol = 2e-5 (f32) and 2e-2 (bf16) for flash attention,
atol = 2e-5 * D and rtol = 2e-5 (f32), 2e-2 * D and 2e-2 (bf16) for the
grouped matmul, whose padding rows must be exactly 0.  Each model-kernel
case is launched twice and the two results must be equal bit for bit:
no sum depends on the order in which blocks finish.
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
        # the engine's (R, 1, M) rows, and len = N*M either side of the
        # warp/CTA threshold (1024), with and without len % 4 == 0
        cases = {f"random {s}": ((rng.integers(0, 6, s) * 0.5).astype(f32),
                                 rng.random(s) < 0.6)
                 for s in ((4096, 1, 32), (64, 1, 32), (5, 33, 7), (3, 1, 1),
                           (6, 1, 30), (5, 1, 1023), (5, 32, 32),
                           (5, 1, 1025), (3, 64, 33))}
        s = (4, 24, 4)
        one_masked = np.ones(s, bool)
        one_masked[:, 9, 2] = False
        z = np.zeros(s, f32)
        z[:, ::2] = -0.0
        cases.update({
            "empty mask": (rng.random(s).astype(f32), np.zeros(s, bool)),
            "+inf valid": (np.full(s, np.inf, f32), one_masked),
            "valid >= BIG": (np.full(s, 2e30, f32), one_masked),
            "-0.0/+0.0": (z, np.ones(s, bool)),
            "all cells +inf, none masked": (np.full(s, np.inf, f32),
                                            np.ones(s, bool))})
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
        # completions +0.0, -0.0, ... along every type row: Min-Min takes
        # machine 0's +0.0, Max-Min's row minimum is -0.0
        pm = np.zeros_like(e)
        pm[..., 1::2] = -0.0
        cases["type rows [+0.0, -0.0, ...]"] = (
            np.full_like(a, -0.0), ib, np.ones_like(rm), tid, pm)
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
        # either side of the per-type / per-task choice: M past one warp,
        # T = 1, T = 64, T > N, the largest type table that fits in 48 KB
        # (TYPE_TABLE_MAX) and one type more, N % 4 != 0, and the captured
        # main-path call
        cases.update({f"random {s}": inst(*s) for s in (
            (6, 40, 33, 3), (6, 40, 64, 5), (6, 40, 6, 1),
            (4, 128, 8, 64), (5, 4, 7, 9), (2, 7000, 4, 6096),
            (2, 7000, 4, 6097), (4, 1001, 33, 3), (409, 1024, 32, 4),
            (3280, 1024, 32, 4))})
        # the K-way drain's speculative views: K = 8 consecutive rows per
        # replica share avail, room and types, each row's batch the
        # previous one less one task
        a, ib, rm, tid, e = inst(6, 128, 8, 3)
        views = np.repeat(ib, 8, 0)
        for j in range(1, 8):
            prev = views[j - 1::8].copy()
            prev[np.arange(6), np.argmax(prev, 1)] = False
            views[j::8] = prev
        cases["K = 8 views"] = tuple(np.repeat(x, 8, 0) if x is not ib
                                     else views for x in (a, ib, rm, tid, e))
        return {k: (v, {}) for k, v in cases.items()}
    if name == "fused_start_pick":
        # the captured main-path shape and N % 4 != 0, the most machines
        # the per-warp tables take (PICK_WARP_MAX) and one more; machines
        # -1 and M are queued on no machine
        cases = {}
        for r, n, m in ((64, 1024, 32), (5, 1000, 7), (3, 1, 1),
                        (4096, 1024, 32), (6, 1001, 32), (16, 1024, 767),
                        (16, 1024, 768)):
            cases[f"random {r}x{n}x{m}"] = (
                rng.integers(0, 8, (r, n)).astype(i32),
                rng.integers(-1, m + 1, (r, n)).astype(i32),
                rng.integers(-1000, 1 << 20, (r, n)).astype(i32), m)
        seq = rng.integers(0, 1 << 20, (4, 64)).astype(i32)
        seq[:, 5:] = 2**31 - 1
        cases["INT_MAX seqs"] = (rng.integers(1, 4, (4, 64)).astype(i32),
                                 rng.integers(0, 5, (4, 64)).astype(i32),
                                 seq, 5)
        dense, on_3 = np.full((8, 1000), 2, i32), np.full((8, 1000), 3, i32)
        cases["every task queued on machine 3"] = (
            dense, on_3, rng.integers(-1000, 1000, (8, 1000)).astype(i32), 32)
        cases["every task queued on machine 3 at seq INT_MAX"] = (
            dense, on_3, np.full_like(on_3, 2**31 - 1), 32)
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
    # the workflow path hides tasks that wait on a parent as status -1
    cases["dep-blocked tasks as -1"] = (
        rng.integers(-1, 8, (64, 1024)).astype(i32),
        rng.uniform(0, 100, (64, 1024)).astype(f32),
        rng.uniform(0, 200, (64, 1024)).astype(f32))
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
        again = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert TK.launches[name] == before + 2, case
        want = plain(*args, **kw)
        for g, a, w in zip(got, again, want):
            assert torch.equal(_bits(g), _bits(w)), f"{name} {case}"
            assert torch.equal(_bits(g), _bits(a)), f"{name} {case} again"


def test_cuda_masked_argmin_unaligned_rows(cuda_device):
    """Rows that start off a 16-byte boundary take the warp layout's
    plain loads, and agree bit for bit all the same."""
    g = torch.Generator().manual_seed(3)
    flat = (torch.randint(0, 6, (64 * 32 + 1,), generator=g) * 0.5)
    values = flat.to(cuda_device)[1:].view(64, 1, 32)
    mask = (torch.rand(64 * 32 + 1, generator=g) < 0.6).to(
        cuda_device)[1:].view(64, 1, 32)
    assert TK.argmin_layout(32, values.data_ptr(), mask.data_ptr()) == 1
    got = TK.masked_argmin(values, mask)
    want = TREF.masked_argmin_ref(values, mask)
    for gg, w in zip(got, want):
        assert torch.equal(_bits(gg), _bits(w))


def test_cuda_fused_unaligned_rows(cuda_device):
    """Min-Min, Max-Min and the start pick on rows that start off a
    16-byte boundary: the per-type and warp layouts' plain loads."""
    g = torch.Generator().manual_seed(4)
    r, n, m, t = 64, 1024, 32, 4

    def off(x):                      # x[1:] of one more element: 4 bytes off
        return x.to(cuda_device)[1:].view(r, n)
    avail = torch.randint(0, 20, (r, m), generator=g).float().to(cuda_device)
    in_batch = off(torch.rand(r * n + 1, generator=g) < 0.5)
    room = (torch.rand(r, m, generator=g) < 0.7).to(cuda_device)
    type_id = off(torch.randint(0, t, (r * n + 1,), generator=g,
                                dtype=torch.int32))
    eet = (torch.randint(1, 9, (r, t, m), generator=g) * 0.5).to(cuda_device)
    assert TK.type_layout(n, t, type_id.data_ptr(), in_batch.data_ptr()) == 1
    status = off(torch.randint(0, 8, (r * n + 1,), generator=g,
                               dtype=torch.int32))
    machine = torch.randint(-1, m + 1, (r, n), generator=g,
                            dtype=torch.int32).to(cuda_device)
    seq = torch.randint(0, 1 << 20, (r, n), generator=g,
                        dtype=torch.int32).to(cuda_device)
    assert TK.pick_layout(n, m, status.data_ptr()) == 1
    for name, args, kw in (
            ("fused_minmin", (avail, in_batch, room, type_id, eet), {}),
            ("fused_maxmin", (avail, in_batch, room, type_id, eet), {}),
            ("fused_start_pick", (status, machine, seq, m), {"in_mq": 2})):
        got = getattr(TK, name)(*args, **kw)
        want = getattr(TREF, name + "_ref")(*args, **kw)
        for gg, w in zip(got, want):
            assert torch.equal(_bits(gg), _bits(w)), name


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


def test_cuda_workflow_path_launches_every_kernel(cuda_device):
    """Workflow mode: all four DAG shapes, failures, ten policies."""
    from repro_torch.launch import experiment as TX
    spec = TX.ExperimentSpec(
        40, TX.FleetAxis(4),
        TX.WorkloadAxis(32, shapes=("chain", "fork_join", "map_reduce",
                                    "layered")),
        scenario=TX.ScenarioAxis(fail_rates=(0.0, 0.3)),
        policy=TX.PolicyAxis(POLICIES), seed=5)
    _launches_all_and_matches_cpu(TX, spec, cuda_device)


@pytest.mark.parametrize("k", [2, 8])
def test_cuda_kway_path_launches_every_kernel(cuda_device, k):
    """The K-way drain on a deep queue (fast arrivals, ``lcap=12``): the
    speculative pair calls at R_p * K rows and the scan's picks."""
    from repro_torch.core import engine as TE
    from repro_torch.launch import experiment as TX
    spec = TX.ExperimentSpec(40, TX.FleetAxis(6),
                             TX.WorkloadAxis(64, rate=50.0),
                             policy=TX.PolicyAxis(POLICIES),
                             sim=TE.SimParams(lcap=12, drain_k=k), seed=5)
    _launches_all_and_matches_cpu(TX, spec, cuda_device)


def _launches_all_and_matches_cpu(TX, spec, dev):
    TK.reset_launches()
    on_card = TX.run_experiment(spec, device=dev)
    torch.cuda.synchronize()
    assert all(TK.launches[name] > 0 for name in TK.NAMES), TK.launches
    on_cpu = TX.run_experiment(spec, device="cpu")
    for key, col in on_cpu.metrics.items():
        assert torch.equal(_bits(on_card.metrics[key]), _bits(col)), key
    for group in ("tasks", "machines"):
        card, cpu = getattr(on_card.state, group), getattr(on_cpu.state,
                                                           group)
        for f in cpu.__dataclass_fields__:
            assert torch.equal(_bits(getattr(card, f)),
                               _bits(getattr(cpu, f))), f


MODEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    width = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.view(width), b.view(width))


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
            # softcap at the widths tests/test_torch_tf32_split.py emulates
            (1, 512, 512, 128, {"causal": True, "softcap": 30.0}),
            (1, 384, 384, 256, {"causal": False, "window": 100,
                                "softcap": 20.0}),
            (2, 96, 32, 32, {"causal": True, "window": 16}),
            # the key-stage edges: below one stage, 2 stages + 1 key for
            # the f32 stages of 64 (hd <= 128) and 16 (hd 256) keys and
            # the bf16 ones of 128; ragged S; hd 256
            (2, 64, 10, 128, {"causal": False}),
            (2, 96, 129, 128, {"causal": False}),
            (2, 80, 129, 64, {"causal": False}),
            (2, 96, 257, 128, {"causal": False}),
            (2, 80, 33, 256, {"causal": False}),
            (2, 1000, 1000, 128, {"causal": True}),
            (2, 300, 300, 256, {"causal": True}),
            (2, 50, 50, 37, {"causal": True})):   # no 16-byte copies
        q, k, v = (torch.randn(bh, s, hd, generator=g).to(cuda_device, dtype)
                   for s in (sq, sk, sk))
        before = TFA.launches["flash_attention"]
        got = TFA.flash_attention(q, k, v, **kw)
        again = TFA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert TFA.launches["flash_attention"] == before + 2
        assert _same_bits(got, again), (bh, sq, sk, hd, kw)
        want = TFA.flash_attention_ref(q, k, v, **kw)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=MODEL_TOL[dtype],
                                   rtol=MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_grouped_matmul_matches_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(1)
    six_live = [1 if i % 11 == 0 else 0 for i in range(64)]
    for gr, c, d, f, sizes in (
            (4, 40, 96, 72, [0, 13, 40, 1]),
            (8, 128, 64, 128, [128, 0, 64, 65, 1, 127, 3, 0]),
            (3, 33, 48, 40, [33, 0, 17]),
            (6, 8, 2048, 200, [1, 0, 0, 1, 0, 1]),
            (4, 32, 16, 24, [0, 0, 0, 0]),
            # either side of the decode/tiled switch (C <= 16 is decode)
            (8, 16, 256, 384, [16, 0, 5, 1, 9, 16, 0, 2]),
            (8, 17, 256, 384, [17, 0, 5, 1, 9, 16, 0, 2]),
            # rows that are not 16-byte multiples, both kernels
            (3, 7, 21, 13, [7, 1, 0]),
            (3, 20, 21, 13, [20, 1, 0]),
            # f32 warpgroup products: a second row tile, a warpgroup of
            # padding rows (64 live), depth and columns past the last
            # slice and tile
            (3, 200, 36, 34, [200, 70, 64]),
            # deepseek-moe-16b's decode calls (w_in, w_out), one token
            # routed to 6 experts, and no token at all
            (64, 8, 2048, 2816, six_live),
            (64, 8, 2048, 2816, [0] * 64),
            (64, 8, 1408, 2048, six_live),
            (64, 8, 1408, 2048, [0] * 64)):
        lhs = torch.randn(gr, c, d, generator=g).to(cuda_device, dtype)
        rhs = torch.randn(gr, d, f, generator=g).to(cuda_device, dtype)
        sz = torch.tensor(sizes, dtype=torch.int32, device=cuda_device)
        got = TGMM.grouped_matmul(lhs, rhs, sz)
        again = TGMM.grouped_matmul(lhs, rhs, sz)
        torch.cuda.synchronize()
        assert _same_bits(got, again), (gr, c, d, f)
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
