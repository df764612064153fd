"""The streaming window engine on a card against the CPU.

Needs an NVIDIA GPU and skips with a reason without one; imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_streaming.py

Tolerance 0: a streaming flat sweep (with trace and metrics) and a
streaming scenario sweep through ``run_experiment``, and a chain and a
fork-join workflow through ``simulate_stream``, each with a window
smaller than the task count, must launch every scheduling kernel the
path runs and give the CPU run's final window, aggregates, summary
columns, trace rows and snapshots bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

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


def _tensors(obj, prefix=""):
    """Every tensor of a (nested) state dataclass, by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_tensors(v, f"{prefix}{f.name}."))
    return out


def assert_windows_equal(card, cpu):
    a, b = _tensors(card), _tensors(cpu)
    assert a.keys() == b.keys()
    for key in b:
        x, y = a[key], b[key]
        if key.startswith("sim.trace.ev_"):
            cap = cpu.sim.trace.cap
            valid = torch.arange(cap)[None, :] < cpu.sim.trace.n_rows[:, None]
            x = torch.where(valid, _bits(x[:, :cap]), 0)
            y = torch.where(valid, _bits(y[:, :cap]), 0)
        assert torch.equal(_bits(x), _bits(y)), key


@pytest.mark.parametrize("scenario", [False, True])
def test_cuda_streaming_sweep_matches_cpu(cuda_device, scenario):
    from repro_torch.launch import experiment as TX
    spec = TX.ExperimentSpec(
        40, TX.FleetAxis(4),
        TX.WorkloadAxis(48, streaming=12, stream_chunk=8),
        scenario=TX.ScenarioAxis(fail_rates=(0.0, 0.3), spot_frac=0.5)
        if scenario else None,
        policy=TX.PolicyAxis(POLICIES), trace=not scenario,
        metrics=not scenario, seed=5)
    TK.reset_launches()
    on_card = TX.run_experiment(spec, device=cuda_device)
    torch.cuda.synchronize()
    assert all(TK.launches[name] > 0 for name in TK.NAMES), TK.launches
    on_cpu = TX.run_experiment(spec, device="cpu")
    for key, col in on_cpu.metrics.items():
        assert torch.equal(_bits(on_card.metrics[key]), _bits(col)), key
    assert_windows_equal(on_card.window, on_cpu.window)
    assert bool((on_cpu.window.agg.retired == 48).all())


@pytest.mark.parametrize("shape", ["chain", "fork_join"])
def test_cuda_streaming_workflow_matches_cpu(cuda_device, shape):
    from repro_torch.core import streaming as TST
    from repro_torch.core import workload as TW
    from repro_torch.core.eet import synth_eet
    eet = synth_eet(3, 2, inconsistency=0.4, seed=7)
    me = eet.eet.mean(1)
    wf = TW.chain_workflow(40, 3, mean_eet=me, slack_jitter=0.4, seed=9) \
        if shape == "chain" else TW.fork_join_workflow(
            8, 3, 3, mean_eet=me, slack_jitter=0.4, seed=9)
    power = np.array([[20.0, 120.0], [35.0, 200.0]], np.float32)
    mtype = np.array([0, 1, 1, 0])
    window = TST.min_window(wf.parents) + 4
    assert window < wf.n_tasks
    runs = [TST.simulate_stream(wf, eet, power, mtype, "heft", window=window,
                                chunk=5, lcap=3, trace=True, device=dev)
            for dev in (cuda_device, "cpu")]
    assert_windows_equal(runs[0].ws, runs[1].ws)
    assert not runs[1].stalled
    assert runs[0].summarize() == runs[1].summarize()
