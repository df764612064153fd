"""The port's scenario inputs and experiment layer against the JAX package.

The numpy draws (the five arrival generators, ``failure_trace``,
``make_scenario``, ``Scenario.dynamics``) and ``normalize`` of a spec
with a ``ScenarioAxis`` must be bit-equal to the reference's.  On
replicas whose products are exact (unit noise, powers-of-two power
tables and DVFS multipliers) every summary column, the scenario columns
included, the ``by_policy`` rows and the report row must be bitwise
equal; on the spec's own draws the count columns are held exactly and
the float columns to the oracle suite's tolerance (ROADMAP.md, queue C).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as E
from repro.core import report as JR
from repro.core import workload as JW
from repro.launch import experiment as X
from repro_torch import interop
from repro_torch.core import report as TR
from repro_torch.core import workload as TW
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
COUNTS = ("completed", "missed", "cancelled", "preempted", "requeues")
SCENARIO = dict(fail_rates=(0.0, 0.3), dvfs_states=("powersave", "turbo"),
                spot_frac=0.5)


def _same_arrays(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


# ---------------------------------------------------------------------------
# numpy inputs
# ---------------------------------------------------------------------------
GENERATORS = {
    "uniform": lambda m, seed: m.uniform_workload(40, 30.0, 3, seed=seed),
    "bursty": lambda m, seed: m.bursty_workload(40, 2.0, 3, seed=seed),
    "diurnal": lambda m, seed: m.diurnal_workload(40, 2.0, 3, seed=seed),
    "onoff": lambda m, seed: m.onoff_workload(40, 2.0, 3, seed=seed),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_arrival_generators_bit_equal(name):
    for seed in (0, 11):
        a, b = GENERATORS[name](JW, seed), GENERATORS[name](TW, seed)
        for col in ("arrival", "type_id", "deadline"):
            _same_arrays(getattr(a, col), getattr(b, col), f"{name} {col}")


def test_arrival_registry_bit_equal():
    assert sorted(TW.ARRIVAL_GENERATORS) == sorted(JW.ARRIVAL_GENERATORS)
    me = np.array([1.0, 2.5, 0.5], np.float32)
    for name in TW.ARRIVAL_GENERATORS:
        a = JW.ARRIVAL_GENERATORS[name](32, 3.0, 3, me, 5)
        b = TW.ARRIVAL_GENERATORS[name](32, 3.0, 3, me, 5)
        _same_arrays(a.arrival, b.arrival, name)
        _same_arrays(a.deadline, b.deadline, name)
    assert TW.resolve_arrivals(["onoff"]) == ("onoff",)
    with pytest.raises(ValueError, match="already registered"):
        TW.register_arrival_generator("poisson", None)


@pytest.mark.parametrize("dvfs", ["nominal", "balanced", "powersave",
                                  "turbo", (0.5, 0.25)])
def test_make_scenario_bit_equal(dvfs):
    assert TW.DVFS_STATES == JW.DVFS_STATES
    wl = JW.poisson_workload(16, 3.0, 2, seed=1)
    for fail_rate, spot, seed in ((0.0, False, 0), (0.2, True, 3),
                                  (0.5, False, 8)):
        kw = dict(fail_rate=fail_rate, mttr=3.0, spot=spot, dvfs=dvfs,
                  n_intervals=3, seed=seed)
        a, b = JW.make_scenario(wl, 5, **kw), TW.make_scenario(wl, 5, **kw)
        assert a.name == b.name
        for col in ("speed", "power_scale", "down_start", "down_end",
                    "kill"):
            _same_arrays(getattr(a, col), getattr(b, col), col)
        ja, tb = a.dynamics(), b.dynamics(device="cpu")
        for col in ("speed", "power_scale", "down_start", "down_end",
                    "kill"):
            _same_arrays(np.asarray(getattr(ja, col))[None],
                         getattr(tb, col).numpy(), f"dynamics {col}")
    ds_a, de_a = JW.failure_trace(4, 6, mtbf=10.0, mttr=2.0, seed=3)
    ds_b, de_b = TW.failure_trace(4, 6, mtbf=10.0, mttr=2.0, seed=3)
    _same_arrays(ds_a, ds_b, "down_start")
    _same_arrays(de_a, de_b, "down_end")


def _specs(n_replicas=40, arrivals=None, seed=2):
    kw = dict(n_tasks=32, arrivals=arrivals)
    jspec = X.ExperimentSpec(n_replicas, X.FleetAxis(4), X.WorkloadAxis(**kw),
                             scenario=X.ScenarioAxis(**SCENARIO),
                             policy=X.PolicyAxis(POLICIES), seed=seed)
    tspec = TX.ExperimentSpec(n_replicas, TX.FleetAxis(4),
                              TX.WorkloadAxis(**kw),
                              scenario=TX.ScenarioAxis(**SCENARIO),
                              policy=TX.PolicyAxis(POLICIES), seed=seed)
    return jspec, tspec


def test_normalize_scenario_bit_equal():
    """Every stacked input, the dynamics included, for a grid over fail
    rates x DVFS states x policies x arrival processes."""
    jspec, tspec = _specs(n_replicas=64, arrivals=("poisson", "bursty"))
    a, b = X.normalize(jspec), TX.normalize(tspec, device="cpu")
    pairs = [("arrival", a.tasks.arrival, b.tasks.arrival),
             ("type_id", a.tasks.type_id, b.tasks.type_id),
             ("deadline", a.tasks.deadline, b.tasks.deadline),
             ("mtype", a.mtype, b.mtype), ("eet", a.tables.eet, b.tables.eet),
             ("power", a.tables.power, b.tables.power),
             ("noise", a.tables.noise, b.tables.noise),
             ("policy_ids", a.policy_ids, b.policy_ids)]
    for col in ("speed", "power_scale", "down_start", "down_end", "kill"):
        pairs.append((col, getattr(a.dynamics, col),
                      getattr(b.dynamics, col)))
    for name, x, y in pairs:
        _same_arrays(x, y.numpy(), name)
    assert b.dynamics.kill.any() and not b.dynamics.kill.all()


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------
def _pow2(x):
    return jnp.exp2(jnp.round(jnp.log2(x)))


@pytest.fixture(scope="module")
def exact_runs():
    """The scenario grid with exact products (powers-of-two power tables
    and DVFS multipliers, unit noise) through the reference's compiled
    sweep, the reference's summary evaluated outside it, and the port."""
    jspec, tspec = _specs()
    reps = X.normalize(jspec)
    tb, dyn = reps.tables, reps.dynamics
    reps = reps._replace(
        tables=dataclasses.replace(tb, power=_pow2(tb.power),
                                   noise=jnp.ones_like(tb.noise)),
        dynamics=dataclasses.replace(dyn, speed=_pow2(dyn.speed),
                                     power_scale=_pow2(dyn.power_scale)))
    jres = X.run_experiment(jspec, replicas=reps)
    sj = E.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                     E.SimParams(), reps.dynamics)
    eager = jax.vmap(X.summarize_replica)(sj, reps.tables, reps.dynamics)
    treps = interop.replicas_from_numpy(reps.tasks, reps.mtype, reps.tables,
                                        reps.policy_ids, reps.dynamics,
                                        device="cpu")
    return reps, jres, eager, TX.run_experiment(tspec, device="cpu",
                                                replicas=treps)


# summed over machines inside a fused reduction of the compiled sweep,
# in an order XLA picks when it vectorizes (queue C)
VECTORIZED = ("availability", "idle_energy", "energy")


def test_scenario_summaries_bitwise_on_exact_products(exact_runs):
    """Every column bitwise against the reference's summary evaluated
    outside the compiled sweep; against the compiled sweep's, every
    column bitwise but the three that XLA may sum in another order,
    which stay within one rounding."""
    _, jres, eager, tres = exact_runs
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        c = np.asarray(eager[k])
        assert a.dtype == b.dtype == c.dtype, k
        assert c.tobytes() == b.tobytes(), k
        if k in VECTORIZED:
            np.testing.assert_allclose(a, b, rtol=2**-22, err_msg=k)
        else:
            assert a.tobytes() == b.tobytes(), k
    keys = ("completion_rate", "missed", "preempted", "requeues",
            "active_energy", "makespan", "mean_response")
    assert jres.by_policy(keys) == tres.by_policy(keys)
    assert tres.metrics["preempted"].sum() > 0
    assert tres.metrics["requeues"].sum() > 0
    assert (tres.metrics["availability"] < 1).any()


def test_reference_vectorized_sum_order_fault(exact_runs):
    """Queue C fault, on the reference side: inside the compiled sweep
    XLA's CPU backend vectorizes the M-wide sums of ``summarize_replica``
    over a dynamic fleet (for M = 4 as (x0 + x2) + (x1 + x3)), while the
    same expressions evaluated outside it, as ``report.metrics`` does,
    sum left to right; the idle energy and the availability mean then
    differ in the last bit on some replicas of this grid.  The port sums
    left to right."""
    _, jres, eager, tres = exact_runs
    for k in ("availability", "idle_energy"):
        swept, plain = np.asarray(jres.metrics[k]), np.asarray(eager[k])
        assert (swept != plain).any(), k
        np.testing.assert_array_equal(plain, tres.metrics[k].numpy())


@pytest.mark.parametrize("replica", [1, 7, 22, 39])
def test_report_summarize_with_dynamics(exact_runs, replica):
    """The report row of one replica (availability, downtime-corrected
    idle energy, preemption counts) equals the reference's row."""
    reps, _, _, tres = exact_runs
    tasks, mtype, tables, pid, dyn = jax.tree.map(
        lambda x: x[replica], (reps.tasks, reps.mtype, reps.tables,
                               reps.policy_ids, reps.dynamics))
    sj = E.run_sim(tasks, mtype, tables, pid, E.SimParams(), dyn)
    assert JR.summarize(sj, tables, dyn) == TR.summarize(
        tres.state, tres.replicas.tables, replica, tres.replicas.dynamics)


def test_scenario_natural_draws_counts_exact_floats_close():
    jspec, tspec = _specs()
    jres = X.run_experiment(jspec)
    tres = TX.run_experiment(tspec, device="cpu")
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        assert a.dtype == b.dtype, k
        if k in COUNTS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
