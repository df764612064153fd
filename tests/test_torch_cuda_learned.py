"""The learned policies and one ES generation on a card against the CPU.

Needs an NVIDIA GPU and skips with a reason without one; imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_learned.py

Tolerance 0: a flat spec of ``mlp`` and ``linear`` at 64 replicas x 128
tasks x 8 machines with random weights drawn on the host, at K = 1 and
K = 8, must launch the path's kernels and give the CPU run's final state
and summary columns bit for bit (the forward pass sums in a fixed order
with no library product, so the card computes the CPU's scores); one ES
generation at pop 3 on a 4-scenario grid must give the CPU's fitness
values, theta' and best theta bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import sched_argmin as TK

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _fields(st):
    t, m = st.tasks, st.machines
    return {"status": t.status, "machine": t.machine, "seq": t.seq,
            "t_start": t.t_start, "t_end": t.t_end, "energy": m.energy,
            "busy_until": m.busy_until, "active_time": m.active_time,
            "time": st.time, "n_events": st.n_events}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a = a.cpu()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("drain_k", [1, 8])
def test_learned_sweep_card_equals_cpu(cuda_device, drain_k):
    from repro_torch.core import engine as E
    from repro_torch.core import neural as NN
    from repro_torch.launch import experiment as X
    spec = X.ExperimentSpec(64, X.FleetAxis(8), X.WorkloadAxis(128),
                            policy=X.PolicyAxis(("mlp", "linear")),
                            sim=E.SimParams(drain_k=drain_k), learned=True,
                            seed=1)
    pp = NN.init_params(0, device="cpu")
    TK.reset_launches()
    card = X.run_experiment(spec, device=cuda_device, policy_params=pp)
    torch.cuda.synchronize()
    launches = dict(TK.launches)
    cpu = X.run_experiment(spec, device="cpu", policy_params=pp)
    for name in ("masked_argmin", "fused_start_pick", "fused_event_bounds"):
        assert launches[name] > 0, name
    for k, v in _fields(cpu.state).items():
        assert _bits_equal(_fields(card.state)[k], v), k
    for k, v in cpu.metrics.items():
        assert _bits_equal(card.metrics[k], v), k


def test_es_generation_card_equals_cpu(cuda_device):
    from repro_torch.core import engine as E
    from repro_torch.core import neural as NN
    from repro_torch.core import train_policy as TP
    from repro_torch.launch import experiment as X
    from repro_torch.launch import learn as L
    spec = L.grid_spec(4, 32, 4, seed=0)
    cfg = TP.ESConfig(pop=3, generations=1)
    eps = torch.randn((cfg.pop, NN.n_trainable("mlp")),
                      generator=torch.Generator().manual_seed(0))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        grid = X.normalize(spec, device=dev)
        _, fitness_pop, e_scale = TP.make_fitness(grid, E.SimParams(), "mlp")
        init = NN.ee_mlp_params(dev)
        theta, unravel = TP.ravel(init.mlp)
        step = TP.make_es_step(fitness_pop, unravel, init, "mlp", cfg)
        out.append((e_scale,) + tuple(step(theta, eps.to(dev))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1:], out[1][1:]):
        assert _bits_equal(a, b)
