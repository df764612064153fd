"""The traced sweep (trace + metrics) on a card against the CPU.

Needs an NVIDIA GPU and skips with a reason without one; imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py tests/test_torch_cuda_traced.py

Tolerance 0: on a dynamic fleet and on workflows of all four DAG shapes,
``run_experiment(ExperimentSpec(trace=True, metrics=True))`` must launch
every scheduling kernel and give the CPU run's final state, summary
columns (the tail columns among them), trace rows, snapshots and
histogram and window counts bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import sched_argmin as TK

pytestmark = [pytest.mark.torch, pytest.mark.cuda]

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
SNAPSHOTS = ("snap_time", "snap_batch", "snap_mq", "snap_running",
             "snap_energy")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else \
        x.to(torch.int64)


@pytest.mark.parametrize("shapes", [None, ("chain", "fork_join",
                                             "map_reduce", "layered")])
def test_cuda_traced_path_matches_cpu(cuda_device, shapes):
    from repro_torch.launch import experiment as TX
    spec = TX.ExperimentSpec(
        40, TX.FleetAxis(4), TX.WorkloadAxis(32, shapes=shapes),
        scenario=TX.ScenarioAxis(fail_rates=(0.0, 0.3), spot_frac=0.5),
        policy=TX.PolicyAxis(POLICIES), trace=True, metrics=True, seed=5)
    TK.reset_launches()
    on_card = TX.run_experiment(spec, device=cuda_device)
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
    tc, tp = on_card.state.trace, on_cpu.state.trace
    assert torch.equal(tc.n_rows.cpu(), tp.n_rows)
    cap = tp.cap
    valid = torch.arange(cap)[None, :] < tp.n_rows[:, None]
    for f in ("ev_time", "ev_kind", "ev_task", "ev_machine"):
        a = torch.where(valid, _bits(getattr(tc, f)[:, :cap]), 0)
        b = torch.where(valid, _bits(getattr(tp, f)[:, :cap]), 0)
        assert torch.equal(a, b), f
    for f in SNAPSHOTS:
        assert torch.equal(_bits(getattr(tc, f)), _bits(getattr(tp, f))), f
    for f in on_cpu.state.metrics._FIELDS:
        assert torch.equal(getattr(on_card.state.metrics, f).cpu(),
                           getattr(on_cpu.state.metrics, f)), f
