"""The chunked Monte-Carlo path on a card against the CPU.

Needs an NVIDIA GPU and skips with a reason without one; imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_chunked.py

Tolerance 0: a flat and a streaming spec at 64 replicas x 128 tasks x 8
machines through ``run_experiment(chunk=24)`` (chunks of 24, 24 and 16)
must launch every scheduling kernel of the path and give the CPU run's
``SweepAgg`` in every field, and the kept per-replica columns of the
CPU's monolithic run.
"""
from __future__ import annotations

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


def _spec(X, streaming):
    wk = X.WorkloadAxis(128, streaming=32, stream_chunk=16) if streaming \
        else X.WorkloadAxis(128)
    return X.ExperimentSpec(64, X.FleetAxis(8), wk,
                            policy=X.PolicyAxis(POLICIES), seed=1)


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["flat", "streaming"])
def test_chunked_agg_card_equals_cpu(cuda_device, streaming):
    from repro_torch.launch import experiment as X
    spec = _spec(X, streaming)
    TK.reset_launches()
    card = X.run_experiment(spec, device=cuda_device, chunk=24,
                            keep_replicas=True)
    launches = dict(TK.launches)
    cpu = X.run_experiment(spec, device="cpu", chunk=24)
    mono = X.run_experiment(spec, device="cpu")
    assert card.chunked.n_chunks == 3
    for name in TK.NAMES:
        assert launches[name] > 0, name
    a, b = card.agg, cpu.agg
    assert a.columns == b.columns and a.policies == b.policies
    np.testing.assert_array_equal(a.counts, b.counts)
    for k in b.columns:
        for part in ("a", "b", "hist", "vmin", "vmax"):
            x, y = getattr(a, part)[k], getattr(b, part)[k]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (k, part)
    for k, col in mono.metrics.items():
        kept = card.metrics[k]
        assert kept.device.type == "cpu" and torch.equal(kept, col), k
