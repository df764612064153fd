"""The port's serving engine and its reference loop against the JAX
package's, on the CPU.

* ``core/ref_engine.simulate_ref`` against ``repro.core.ref_engine``'s,
  for the ten heuristics on ``conftest.make_instance`` instances: every
  result array equal (tolerance 0; both loops compute in float64 with the
  same operations).
* ``ServingEngine`` in ``run_mode="sim"`` against the JAX engine on the
  traces of ``tests/test_serving.py``: every ``ServeReport`` field equal
  (tolerance 0), but ``wall_seconds``, the host's clock.
* ``run_mode="real"`` with tiny qwen2-1.5b and tiny deepseek-moe-16b,
  and with tiny xlstm-350m and tiny command-r-35b, on the JAX package's
  weights: the same report row, and each request's greedy tokens equal
  the JAX engine's wherever the JAX model's top-2 logit margin exceeds
  1e-3 (up to the first step where a smaller margin lets them part,
  after which the two continue from different prefixes).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_instance
from test_torch_local_attention import assert_xlstm_live, jitter_zero_leaves

from repro.configs.base import get_arch as jax_get_arch
from repro.core import ref_engine as R
from repro.core.workload import poisson_workload
from repro.models import model as JM
from repro.serving import AppSpec as JAppSpec
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import get_arch
from repro_torch.core import ref_engine as TR
from repro_torch.core import workload as TW
from repro_torch.interop import lm_params_from_numpy
from repro_torch.serving import AppSpec, ServeConfig, ServingEngine

pytestmark = pytest.mark.torch

POLICIES = TR.POLICIES
EET = np.array([[0.5, 1.5], [2.0, 0.8]], np.float32)
POWER = np.array([[50., 200.], [30., 120.]], np.float32)
MARGIN = 1e-3


@pytest.mark.parametrize("policy", POLICIES)
def test_ref_engine_equals_reference(policy):
    for seed, kw in ((0, {}), (1, {"lcap": 1, "qcap": 6}),
                     (2, {"cancel_infeasible": False})):
        eet, power, wl, mtype = make_instance(seed, n_tasks=32)
        noise = np.random.default_rng(seed).lognormal(0, 0.3, wl.n_tasks)
        args = (wl.arrival, wl.type_id, wl.deadline, eet.eet, power, mtype)
        got = TR.simulate_ref(*args, policy=policy, noise=noise, **kw)
        want = R.simulate_ref(*args, policy=policy, noise=noise, **kw)
        for f in dataclasses.fields(TR.RefResult):
            g, w = getattr(got, f.name), getattr(want, f.name)
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def _jax_init(cfg, seed, jitter=0.0):
    """The JAX package's ``init_params`` weights, jitted (its eager run
    takes ten times as long on the CPU), with ``jitter``: seeded noise
    on the zero-initialized leaves."""
    params = jax.jit(lambda key: JM.init_params(key, cfg)[0])(
        jax.random.PRNGKey(seed))
    return jitter_zero_leaves(params, jitter, seed + 9)



def test_ref_engine_rejects_learned_policies():
    """The port's oracle runs the learned policies now (their float32
    numpy forward pass), equal to the reference's oracle on every field
    with the same weights, as a numpy dict or as the port's
    ``PolicyParams``; an unknown policy is still refused."""
    from repro.core import neural as JN
    from repro_torch.interop import policy_params_from_numpy
    eet, power, wl, mtype = make_instance(0)
    args = (wl.arrival, wl.type_id, wl.deadline, eet.eet, power, mtype)
    for policy, seed in (("mlp", 2), ("linear", 5)):
        d = JN.params_to_numpy(JN.init_params(seed))
        want = R.simulate_ref(*args, policy=policy, policy_params=d)
        for pp in (d, policy_params_from_numpy(d, "cpu")):
            got = TR.simulate_ref(*args, policy=policy, policy_params=pp)
            for f in dataclasses.fields(TR.RefResult):
                np.testing.assert_array_equal(getattr(got, f.name),
                                              getattr(want, f.name),
                                              err_msg=f"{policy} {f.name}")
    with pytest.raises(ValueError, match="unported policy"):
        TR.simulate_ref(*args, policy="nope")


def _apps(cls):
    return [cls("chat", gen_len=8), cls("summarize", gen_len=32)]


SIM_CASES = {
    "light_load_mct": (dict(policy="mct"), [0, 1, 1],
                       dict(n=40, rate=1.0, slack=6.0, seed=0)),
    "overload_fcfs": (dict(policy="fcfs", cancel_infeasible=False), [0],
                      dict(n=60, rate=20.0, slack=1.5, seed=1)),
    "energy_mct": (dict(policy="mct"), [0, 1],
                   dict(n=60, rate=1.5, slack=8.0, seed=2)),
    "energy_ee_mct": (dict(policy="ee_mct"), [0, 1],
                      dict(n=60, rate=1.5, slack=8.0, seed=2)),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_mode_report_equals_reference(case):
    cfg, mtypes, w = SIM_CASES[case]
    wl = poisson_workload(w["n"], rate=w["rate"], n_task_types=2,
                          mean_eet=EET.mean(1), slack=w["slack"],
                          seed=w["seed"])
    mine_wl = TW.poisson_workload(w["n"], rate=w["rate"], n_task_types=2,
                                  mean_eet=EET.mean(1), slack=w["slack"],
                                  seed=w["seed"])
    for col in ("arrival", "type_id", "deadline"):
        np.testing.assert_array_equal(getattr(mine_wl, col),
                                      getattr(wl, col))
    got = ServingEngine(EET, POWER, mtypes, _apps(AppSpec),
                        ServeConfig(**cfg), device="cpu").run(mine_wl)
    want = JServingEngine(EET, POWER, mtypes, _apps(JAppSpec),
                          JServeConfig(**cfg)).run(wl)
    for f in dataclasses.fields(want):
        if f.name != "wall_seconds":
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)
    assert got.row() == want.row()


def test_eet_app_count_mismatch_raises():
    with pytest.raises(ValueError, match="task types"):
        ServingEngine(EET, POWER, [0], [AppSpec("only-one")], device="cpu")


def _jax_greedy(engine, type_id, params, cfg, prompt, gen_len):
    """The JAX engine's greedy tokens for one request, recomputed with the
    top-2 logit margin of each step: the same eager ``prefill`` and the
    engine's own jitted decode step (no new compilation)."""
    opt = JM.ModelOptions(dtype=jnp.float32, remat=False)
    logits, cache = JM.prefill(params, {"tokens": jnp.asarray(prompt,
                                                              jnp.int32)},
                               cfg, opt,
                               cache_len=prompt.shape[1] + gen_len)
    toks, margins = [], []
    for _ in range(gen_len):
        top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
        margins.append(float(top2[1] - top2[0]))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(int(tok[0, 0]))
        logits, cache = engine._decode_fns[type_id](params, cache, tok)
    return np.asarray(toks), np.asarray(margins)


def _real_mode_matches_reference(archs, seed=3, jitter=0.0):
    """Two tiny apps through both engines in ``run_mode="real"`` on the
    JAX package's weights (``jitter``: noise on the zero-initialized
    leaves): the same report row, and each request's greedy tokens equal
    the JAX engine's wherever its top-2 margin exceeds ``MARGIN``."""
    jcfgs = [jax_get_arch(a).tiny() for a in archs]
    cfgs = [get_arch(a).tiny() for a in archs]
    jparams = [_jax_init(c, i, jitter) for i, c in enumerate(jcfgs)]
    params = [lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                   c, device="cpu")
              for p, c in zip(jparams, cfgs)]
    for p, c in zip(params, cfgs):
        assert_xlstm_live(p, c)
    gen, plen = 4, 8
    eet = np.array([[0.3, 0.6], [0.5, 0.4]], np.float32)
    wl = poisson_workload(5, rate=1.0, n_task_types=2, slack=10.0, seed=seed)
    assert set(wl.type_id.tolist()) == {0, 1}
    cfg = dict(policy="mct", run_mode="real")
    jeng = JServingEngine(eet, POWER, [0, 1], [
        JAppSpec(a, gen_len=gen, arch=c, params=p, prompt_len=plen)
        for a, c, p in zip(archs, jcfgs, jparams)], JServeConfig(**cfg))
    eng = ServingEngine(eet, POWER, [0, 1], [
        AppSpec(a, gen_len=gen, arch=c, params=p, prompt_len=plen)
        for a, c, p in zip(archs, cfgs, params)], ServeConfig(**cfg),
        device="cpu")
    want, got = jeng.run(wl), eng.run(wl)
    assert got.completed == want.completed == 5
    assert got.tokens_generated == want.tokens_generated == 5 * gen
    assert got.row() == want.row()
    assert sorted(eng.outputs) == sorted(jeng.outputs)
    for task, toks in eng.outputs.items():
        t = int(wl.type_id[task])
        prompt = np.random.default_rng(task).integers(
            0, cfgs[t].vocab_size, (1, plen))
        ref_toks, margins = _jax_greedy(jeng, t, jparams[t], jcfgs[t],
                                        prompt, gen)
        np.testing.assert_array_equal(jeng.outputs[task], ref_toks)
        assert toks.shape == (gen,) and toks.dtype == np.int32
        for i in range(gen):
            if margins[i] > MARGIN:
                assert toks[i] == ref_toks[i], (task, i, margins[i])
            elif toks[i] != ref_toks[i]:
                break


def test_real_mode_tokens_match_reference():
    _real_mode_matches_reference(("qwen2-1.5b", "deepseek-moe-16b"))


def test_real_mode_xlstm_and_command_r_match_reference():
    """xlstm-350m (mLSTM and sLSTM blocks) and command-r-35b (parallel
    blocks, LayerNorm) served through both engines, with noise on the
    zero-initialized leaves so that every xLSTM block adds to the
    residual."""
    _real_mode_matches_reference(("xlstm-350m", "command-r-35b"),
                                 jitter=0.1)
