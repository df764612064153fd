"""The port's ES trainer (``core/train_policy.py``) against the JAX
package's.

The same grid (``learn.grid_spec``, drawn by the JAX package and carried
across with ``interop``) and the same weights go through both; the port
replays the reference's noise draws (the ``jax.random.split`` chain of
``repro.core.train_policy.train``).  Tolerances:

* ``miss_energy_score``, ``e_scale``, ``fitness``, ``fitness_pop`` and
  every generation's ``f_all`` (and so each history's ``theta_fitness``,
  ``best`` and ``mean``): 0, bitwise;
* theta', ``gen_best``, the trained weights: rtol 1e-6, atol 1e-7, and
  ``grad_norm`` rtol 1e-6.  The reference's compiler folds the normal
  draw's sqrt(2) scale into the perturbation and the gradient (its
  compiled step never rounds the noise itself), so its update agrees
  with any update from the rounded noise to a few ulps, not bitwise.

A generation is one ``engine.run_sweep`` call, counted as the JAX
suite's ``test_es_generation_is_one_jitted_call`` counts its traces.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import engine as E
from repro.core import neural as JN
from repro.core import train_policy as TP
from repro.launch import learn as JL
from repro.launch.experiment import normalize
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import neural as NN
from repro_torch.core import train_policy as TTP

pytestmark = pytest.mark.torch

CFG = dict(pop=3, seed=0)
TOL = dict(rtol=1e-6, atol=1e-7)


def port_params(pp):
    return interop.policy_params_from_numpy(JN.params_to_numpy(pp), "cpu")


def jax_noise(cfg, d):
    """The reference's per-generation draws: ``key, sub = split(key)``,
    then ``normal(sub, (pop, D))``."""
    key, out = jax.random.PRNGKey(cfg.seed), []
    for _ in range(cfg.generations):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (cfg.pop, d),
                                                jnp.float32)))
    return out


@pytest.fixture(scope="module")
def grid():
    """A 4-scenario grid of 16 tasks on 3 machines (failures, DVFS, two
    arrival processes), both packages' form."""
    legacy = normalize(JL.grid_spec(4, 16, 3, seed=0)).legacy()
    return legacy, interop.replicas_from_numpy(*legacy, device="cpu")


@pytest.fixture(scope="module")
def fitness(grid):
    jgrid, tgrid = grid
    return (TP.make_fitness(jgrid, E.SimParams(), "mlp"),
            TTP.make_fitness(tgrid, TE.SimParams(), "mlp"))


def test_miss_energy_score_bitwise():
    rng = np.random.default_rng(0)
    m = {"completion_rate": rng.random(64).astype(np.float32),
         "energy": rng.uniform(100, 9000, 64).astype(np.float32)}
    for e_scale, w in ((2817.34375, 0.2), (1234.5, 0.0), (3.0, 1.7)):
        want = np.asarray(TP.miss_energy_score(
            {k: jnp.asarray(v) for k, v in m.items()}, jnp.float32(e_scale),
            w))
        got = TTP.miss_energy_score(
            {k: torch.from_numpy(v) for k, v in m.items()}, e_scale,
            w).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_make_fitness_bitwise(grid, fitness):
    """``e_scale`` (MCT's grid-mean energy), ``fitness`` with shared
    weights and ``fitness_pop`` over stacked ones."""
    (jfit, jpop, je), (tfit, tpop, te) = fitness
    assert te == je and isinstance(te, float)
    jgrid, tgrid = grid
    raw = TP.heuristic_scores(jgrid, ["mct", "ee_mct"], raw_energy=True)
    traw = TTP.heuristic_scores(tgrid, ["mct", "ee_mct"], raw_energy=True)
    for k in raw:
        np.testing.assert_array_equal(traw[k], raw[k], err_msg=k)
    for p in (JN.ee_mlp_params(), JN.init_params(2)):
        assert float(tfit(port_params(p))) == float(jax.jit(jfit)(p))
    pops = jax.tree.map(lambda *x: jnp.stack(x),
                        *[JN.init_params(s) for s in (0, 3, 7, 9)])
    np.testing.assert_array_equal(tpop(port_params(pops)).numpy(),
                                  np.asarray(jax.jit(jpop)(pops)))


def test_es_step_replayed(fitness):
    """One generation with the reference's noise: ``f_all`` bitwise,
    theta', ``grad_norm`` and ``gen_best`` to rounding."""
    (_, jpop, _), (_, tpop, _) = fitness
    cfg = TP.ESConfig(generations=1, **CFG)
    init = JN.ee_mlp_params()
    theta0, unravel = ravel_pytree(init.mlp)
    key = jax.random.split(jax.random.PRNGKey(7))[1]
    want = [np.asarray(x) for x in
            TP.make_es_step(jpop, unravel, init, "mlp", cfg)(theta0, key)]
    eps = np.asarray(jax.random.normal(key, (cfg.pop, theta0.shape[0]),
                                       jnp.float32))
    tinit = port_params(init)
    th0, tunravel = TTP.ravel(tinit.mlp)
    step = TTP.make_es_step(tpop, tunravel, tinit, "mlp",
                            TTP.ESConfig(generations=1, **CFG))
    got = [x.numpy() for x in step(th0, torch.from_numpy(eps.copy()))]
    np.testing.assert_array_equal(got[1], want[1])           # f_all
    assert got[1].shape == (2 * cfg.pop + 1,)
    np.testing.assert_allclose(got[0], want[0], **TOL)       # theta'
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)   # grad_norm
    np.testing.assert_allclose(got[3], want[3], **TOL)       # gen_best


@pytest.mark.parametrize("policy", ["mlp", "linear"])
def test_train_two_generations_replayed(grid, policy):
    """``train`` for two generations: history and fitness equal to the
    reference's, the weights to rounding."""
    jgrid, tgrid = grid
    kw = dict(generations=2, sigma=0.1, **CFG)
    want = TP.train(jgrid, policy=policy, cfg=TP.ESConfig(**kw))
    d = JN.n_trainable(policy)
    draws = jax_noise(TP.ESConfig(**kw), d)
    got = TTP.train(tgrid, policy=policy, cfg=TTP.ESConfig(**kw),
                    noise=lambda g: torch.from_numpy(draws[g].copy()))
    assert got.fitness == want.fitness
    for g, w in zip(got.history, want.history):
        for k in ("gen", "theta_fitness", "best", "mean"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-6)
    np.testing.assert_allclose(got.theta, want.theta, **TOL)
    wp, gp = JN.params_to_numpy(want.params), \
        NN.params_to_numpy(got.params)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], err_msg=k, **TOL)


def test_es_generation_is_one_run_sweep_call(grid, monkeypatch):
    """Each generation evaluates its 2 pop + 1 parameter sets on every
    scenario as ONE ``run_sweep`` of (2 pop + 1) x S replicas, each with
    its own weights."""
    _, tgrid = grid
    calls = []
    real = TE.run_sweep

    def counting(tasks, *a, **kw):
        calls.append(tasks.arrival.shape[0])
        return real(tasks, *a, **kw)

    cfg = TTP.ESConfig(generations=3, **CFG)
    _, fitness_pop, _ = TTP.make_fitness(tgrid, TE.SimParams(), "mlp",
                                         e_scale=1000.0)
    init = NN.ee_mlp_params("cpu")
    theta, unravel = TTP.ravel(init.mlp)
    step = TTP.make_es_step(fitness_pop, unravel, init, "mlp", cfg)
    monkeypatch.setattr(TE, "run_sweep", counting)
    gen = torch.Generator().manual_seed(0)
    for g in range(cfg.generations):
        theta, f_all, _, _ = step(theta, torch.randn(
            (cfg.pop, theta.shape[0]), generator=gen))
        assert f_all.shape == (2 * cfg.pop + 1,)
        assert calls == [(2 * cfg.pop + 1) * 4] * (g + 1)
    # and train: the e_scale sweep once, then one call a generation
    calls.clear()
    TTP.train(tgrid, "linear", cfg=cfg)
    assert calls == [4] + [(2 * cfg.pop + 1) * 4] * cfg.generations


def test_train_default_noise_is_seeded_and_elitist(grid):
    """The default host draws depend on ``cfg.seed`` only; the returned
    fitness never exceeds the warm start's."""
    _, tgrid = grid
    cfg = TTP.ESConfig(generations=2, **CFG)
    a = TTP.train(tgrid, "linear", cfg=cfg)
    b = TTP.train(tgrid, "linear", cfg=cfg)
    assert a.history == b.history
    np.testing.assert_array_equal(a.theta, b.theta)
    assert a.fitness <= a.history[0]["theta_fitness"]
    with pytest.raises(ValueError, match="not a learned policy"):
        TTP.train(tgrid, "mct", cfg=cfg)
