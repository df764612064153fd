"""In-simulator policy training: antithetic evolution strategies on
batched scenario fleets.

The counterpart of ``repro.core.train_policy``.  OpenAI-style antithetic
ES (Salimans et al. 2017)::

  theta_{g+1} = theta_g - lr * 1/(2 P sigma) * sum_i (f(theta+sigma e_i)
                - f(theta-sigma e_i)) e_i

with ``f`` the mean energy-weighted deadline-miss score over a grid of
training scenarios.  One generation evaluates the incumbent and its 2P
perturbations on every scenario as ONE ``engine.run_sweep`` call over
(2P + 1) x S replicas, each replica with its own weights (the leading R
axis of ``neural.PolicyParams``): the counterpart of the reference's one
jitted call.

The reference draws ``e`` with ``jax.random`` inside its jitted step.
Here ``e`` is drawn on the host from a CPU ``torch.Generator`` seeded
with ``ESConfig.seed`` and copied to the run's device, so the card and
the CPU see the same numbers; ``train(noise=)`` replaces the draws (a
test replays the reference's).  The reference's compiler folds the
normal's scale into the perturbation and the gradient, so its theta
agrees with this update to rounding, not bit for bit; the fitness values
depend only on the simulated decisions and agree exactly.

The trainer is elitist with a margin: the incumbent is evaluated beside
its perturbations each generation, and the best parameters by train
fitness are returned, a challenger accepted only when it beats the best
by ``elite_margin``.  Only the trained family's weights are flattened
into ``theta``, in the field and row-major order of the reference's
``ravel_pytree`` (``w1, b1, w2, b2``: 177 values for ``mlp``, 9 for
``linear``), so theta vectors and noise rows line up with the
reference's; the other family rides along frozen.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import neural as NN
from repro_torch.core import schedulers as P
from repro_torch.core.reduce import fma, ordered_sum
from repro_torch.launch.experiment import summarize_replica


@dataclass(frozen=True)
class ESConfig:
    """Hyperparameters of one ES run (the reference's defaults)."""
    pop: int = 8               # antithetic pairs per generation
    sigma: float = 0.05        # perturbation scale
    lr: float = 0.05           # step size on theta
    generations: int = 10
    energy_weight: float = 0.2  # w in miss_frac + w * energy / e_scale
    elite_margin: float = 0.005  # a challenger must beat the best by this
    seed: int = 0              # seeds the host noise generator


@dataclass
class TrainResult:
    params: NN.PolicyParams          # best parameters (train fitness)
    fitness: float                   # their training fitness
    history: list = field(default_factory=list)   # per generation
    policy: str = "mlp"
    theta: np.ndarray | None = None  # final (not necessarily best) theta


# --------------------------------------------------------------------------
# Flattening one family
# --------------------------------------------------------------------------
def ravel(family) -> tuple[torch.Tensor, Callable]:
    """(theta (D,), unravel) of one family (``MLPParams`` or
    ``LinearParams``): its leaves flattened row-major in field order.
    ``unravel`` takes (D,) or (K, D) and returns the family, with a
    leading K axis for the latter."""
    leaves = list(family)
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]
    theta = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(theta: torch.Tensor):
        lead = theta.shape[:-1]
        parts = torch.split(theta, sizes, dim=-1)
        return type(family)(*(p.reshape(lead + s)
                              for p, s in zip(parts, shapes)))

    return theta, unravel


def _with_family(frozen: NN.PolicyParams, policy: str, fam
                 ) -> NN.PolicyParams:
    """``frozen`` with family ``policy`` replaced; a stacked family gets
    the frozen one broadcast along its leading axis."""
    other = "linear" if policy == "mlp" else "mlp"
    keep = getattr(frozen, other)
    if NN.stacked(fam) and not NN.stacked(keep):
        k = fam[0].shape[0]
        keep = type(keep)(*(x.expand((k,) + x.shape) for x in keep))
    return frozen._replace(**{policy: fam, other: keep})


# --------------------------------------------------------------------------
# Objective
# --------------------------------------------------------------------------
def miss_energy_score(metrics: dict, e_scale,
                      energy_weight: float = 0.2) -> torch.Tensor:
    """Energy-weighted deadline-miss score per replica, lower is better:
    ``1 - completion_rate`` (every task that did not finish) plus
    ``energy_weight * energy / e_scale``, each operation rounded on its
    own, as the reference computes it outside a compiled call."""
    energy = metrics["energy"]
    e = torch.full_like(energy, float(e_scale))
    return (1.0 - metrics["completion_rate"]) + energy_weight * energy / e


def grid_inputs(train_inputs) -> tuple:
    """(tasks, mtype, tables, dynamics) of a ``Replicas``, a legacy
    4- or 5-tuple (its policy ids are ignored)."""
    if hasattr(train_inputs, "legacy"):
        train_inputs = train_inputs.legacy()
    tt, mt, tb = train_inputs[:3]
    dyn = train_inputs[4] if len(train_inputs) > 4 else None
    return tt, mt, tb, dyn


def tile(x, idx: torch.Tensor):
    if x is None:
        return None
    return x.take(idx) if hasattr(x, "take") else x[idx]


def make_fitness(train_inputs, sim_params: E.SimParams = E.SimParams(),
                 policy: str = "mlp", energy_weight: float = 0.2,
                 e_scale: float | None = None):
    """-> ``(fitness, fitness_pop, e_scale)``: ``fitness(params)`` the
    mean score over the grid with shared weights, ``fitness_pop(
    stacked)`` the (K,) scores of K parameter sets (leading axis K on
    every leaf), each over every scenario, as one ``run_sweep`` of K x S
    replicas.  ``train_inputs``: ``normalize(learn.grid_spec(...))`` or
    its legacy tuple, on the device the training runs on.  ``e_scale``
    defaults to MCT's grid-mean energy, swept once here.

    The reference's compiler rewrites the score inside its compiled call
    (found by test): ``1 - completed / n`` as one multiply-add with the
    float32 reciprocal of n, the energy term as one multiply-add by
    ``energy_weight * (1 / e_scale)``, and the mean over scenarios as a
    left-to-right sum times the reciprocal of S.  Both devices compute
    that form, with tensors (a CUDA division by a Python number would
    multiply by its reciprocal)."""
    tt, mt, tb, dyn = grid_inputs(train_inputs)
    dev = mt.device
    n_scen, n_tasks = tt.arrival.shape
    pid = P.POLICY_IDS[policy]
    if e_scale is None:
        e_scale = float(np.mean(heuristic_scores(
            train_inputs, ["mct"], sim_params, energy_weight=0.0,
            raw_energy=True)["mct"]))
    f32 = np.float32

    def const(x):
        return torch.full((), x, dtype=torch.float32, device=dev)

    one, inv_n = const(1.0), const(f32(1) / f32(n_tasks))
    w_inv_e = const(f32(energy_weight) * (f32(1) / f32(e_scale)))
    inv_s = const(f32(1) / f32(n_scen))

    def scores(params: NN.PolicyParams, k: int) -> torch.Tensor:
        """(k, S) scores of the k parameter sets (None: shared)."""
        idx = torch.arange(k * n_scen, device=dev) % n_scen
        tables, dynamics = tile(tb, idx), tile(dyn, idx)
        st = E.run_sweep(tile(tt, idx), mt[idx], tables,
                         torch.full((k * n_scen,), pid, dtype=torch.int32,
                                    device=dev),
                         sim_params, dynamics=dynamics, policy_params=params)
        m = summarize_replica(st, tables, dynamics)
        completed = m["completed"].to(torch.float32)
        miss = fma(-completed, inv_n.expand_as(completed),
                   one.expand_as(completed))
        sc = fma(m["energy"], w_inv_e.expand_as(completed), miss)
        return sc.view(k, n_scen)

    def fitness(params: NN.PolicyParams) -> torch.Tensor:
        return (ordered_sum(scores(params, 1), 1) * inv_s)[0]

    def fitness_pop(stacked: NN.PolicyParams) -> torch.Tensor:
        k = stacked.mlp.w1.shape[0]
        rep = NN.map_params(lambda x: x.repeat_interleave(n_scen, 0),
                            stacked)
        return ordered_sum(scores(rep, k), 1) * inv_s

    return fitness, fitness_pop, e_scale


def heuristic_scores(inputs, policies: list[str],
                     sim_params: E.SimParams = E.SimParams(),
                     energy_weight: float = 0.2, e_scale: float = 1.0,
                     raw_energy: bool = False) -> dict:
    """Per-policy per-scenario scores (numpy) of heuristic baselines on
    a grid, one sweep each; ``raw_energy=True`` gives each replica's
    total energy instead (used to calibrate ``e_scale``)."""
    tt, mt, tb, dyn = grid_inputs(inputs)
    out = {}
    for pol in policies:
        pids = torch.full((mt.shape[0],), P.POLICY_IDS[pol],
                          dtype=torch.int32, device=mt.device)
        st = E.run_sweep(tt, mt, tb, pids, sim_params, dynamics=dyn)
        m = summarize_replica(st, tb, dyn)
        out[pol] = (m["energy"] if raw_energy else miss_energy_score(
            m, e_scale, energy_weight)).cpu().numpy()
    return out


# --------------------------------------------------------------------------
# The ES loop
# --------------------------------------------------------------------------
def make_es_step(fitness_pop, unravel, frozen: NN.PolicyParams,
                 policy: str, cfg: ESConfig):
    """-> ``step(theta, eps) -> (theta', f_all, grad_norm, gen_best)``
    for ``eps`` the (pop, D) noise on theta's device: ``f_all`` (2 pop +
    1,) holds the incumbent's fitness, then the +sigma and the -sigma
    perturbations'; ``gen_best`` is the evaluated theta with the lowest
    fitness (the first on ties).  The 2 pop + 1 evaluations are one
    ``fitness_pop`` call.  The divisions are by tensors on theta's
    device, so the card divides as the CPU does."""
    def step(theta: torch.Tensor, eps: torch.Tensor):
        thetas = torch.cat([theta[None], theta[None] + cfg.sigma * eps,
                            theta[None] - cfg.sigma * eps])
        f_all = fitness_pop(_with_family(frozen, policy, unravel(thetas)))
        diff = f_all[1:cfg.pop + 1] - f_all[cfg.pop + 1:]
        n_pop = torch.full_like(theta, float(cfg.pop))
        two_sigma = torch.full_like(theta, 2.0 * cfg.sigma)
        grad = ordered_sum(diff[:, None] * eps, 0) / n_pop / two_sigma
        theta_new = theta - cfg.lr * grad
        return (theta_new, f_all, torch.sqrt(ordered_sum(grad * grad, 0)),
                thetas[torch.argmin(f_all)])

    return step


def train(train_inputs, policy: str = "mlp",
          sim_params: E.SimParams = E.SimParams(),
          cfg: ESConfig = ESConfig(),
          init: NN.PolicyParams | None = None, *,
          noise: Callable[[int], torch.Tensor] | None = None
          ) -> TrainResult:
    """Train one learned family with antithetic ES on the device of
    ``train_inputs``.  ``init`` defaults to the ``ee_mct``-equivalent
    warm start, so generation 0's incumbent matches the strongest
    energy-aware heuristic.  ``noise(g)`` gives generation g's (pop, D)
    noise; the default draws it from a CPU generator seeded with
    ``cfg.seed``."""
    if policy not in NN.LEARNED_POLICIES:
        raise ValueError(f"not a learned policy: {policy!r}")
    dev = grid_inputs(train_inputs)[1].device
    init = (init if init is not None else NN.ee_mlp_params(dev)).to(dev)
    theta0, unravel = ravel(getattr(init, policy))
    _, fitness_pop, _ = make_fitness(train_inputs, sim_params, policy,
                                     cfg.energy_weight)
    step = make_es_step(fitness_pop, unravel, init, policy, cfg)
    if noise is None:
        gen = torch.Generator().manual_seed(int(cfg.seed))

        def noise(g):
            return torch.randn((cfg.pop, theta0.shape[0]), generator=gen,
                               dtype=torch.float32)

    theta = theta0
    best_theta, best_f = theta0, float("inf")
    history = []
    for g in range(cfg.generations):
        eps = torch.as_tensor(noise(g), dtype=torch.float32).to(dev)
        theta_new, f_all, gnorm, gen_best = step(theta, eps)
        f_all = f_all.cpu().numpy()
        # elitism over everything evaluated this generation; gen 0's
        # incumbent (the warm start) seeds best_f without a margin
        if best_f == float("inf"):
            best_f, best_theta = float(f_all[0]), theta
        if float(f_all.min()) < best_f - cfg.elite_margin:
            best_f = float(f_all.min())
            best_theta = gen_best
        history.append({"gen": g, "theta_fitness": float(f_all[0]),
                        "best": float(f_all.min()),
                        "mean": float(f_all.mean()),
                        "grad_norm": float(gnorm)})
        theta = theta_new
    best = init._replace(**{policy: unravel(best_theta)})
    return TrainResult(params=best, fitness=best_f, history=history,
                       policy=policy, theta=theta.cpu().numpy())
