"""The port's workflow experiment layer against the JAX package.

``WorkloadAxis(shapes=...)`` switches a spec to workflow mode: paired
cells (the ``n_p`` replicas of a cell share one DAG, EET draw, fleet and
failure trace), HEFT ranks, parent tables padded to the grid's widest
in-degree (``_workflow_kmax``) and dynamics on every cell.  ``normalize``
must be bit-equal to the reference's for all four shapes and ten
policies; on replicas with exact products (unit noise, powers-of-two
power tables and DVFS multipliers) ``run_experiment``'s final state is
bitwise the JAX ``run_sweep(parents=)`` and its summaries bitwise the
reference's summary evaluated outside the compiled sweep (the three
columns XLA may sum in another order inside it within one rounding, as
for the scenario sweep, ROADMAP.md queue C); on the spec's own draws the
count columns are exact and the floats within the oracle suite's
tolerance.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as E
from repro.launch import experiment as X
from repro_torch import interop
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
SHAPES = ("chain", "fork_join", "map_reduce", "layered")
COUNTS = ("completed", "missed", "cancelled", "preempted", "requeues")
VECTORIZED = ("availability", "idle_energy", "energy")
SCENARIO = dict(fail_rates=(0.0, 0.3), dvfs_states=("powersave",),
                spot_frac=0.5)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _specs(n_replicas=60, n_tasks=24, seed=4, scenario=True):
    wk = dict(n_tasks=n_tasks, shapes=SHAPES)
    jspec = X.ExperimentSpec(
        n_replicas, X.FleetAxis(4), X.WorkloadAxis(**wk),
        scenario=X.ScenarioAxis(**SCENARIO) if scenario else None,
        policy=X.PolicyAxis(POLICIES), seed=seed)
    tspec = TX.ExperimentSpec(
        n_replicas, TX.FleetAxis(4), TX.WorkloadAxis(**wk),
        scenario=TX.ScenarioAxis(**SCENARIO) if scenario else None,
        policy=TX.PolicyAxis(POLICIES), seed=seed)
    return jspec, tspec


def test_workload_axis_validation():
    assert TX.WorkloadAxis(8, shapes=["chain"]).shapes == ("chain",)
    with pytest.raises(ValueError, match="arrivals OR shapes"):
        TX.WorkloadAxis(8, arrivals=("poisson",), shapes=("chain",))
    with pytest.raises(ValueError, match="unknown workflow generators"):
        TX.WorkloadAxis(8, shapes=("spiral",))
    _, tspec = _specs()
    assert tspec.workflow and not dataclasses.replace(
        tspec, workload=TX.WorkloadAxis(8)).workflow


@pytest.mark.parametrize("scenario", [True, False])
def test_normalize_workflow_bit_equal(scenario):
    """Every stacked input (ranks, dynamics and padded parent tables
    included) for a grid over all four shapes, paired policies and, with
    a scenario axis, fail rates; a grid that ends inside a cell too."""
    for n_replicas in (57, 40):
        jspec, tspec = _specs(n_replicas, scenario=scenario)
        a, b = X.normalize(jspec), TX.normalize(tspec, device="cpu")
        pairs = [("arrival", a.tasks.arrival, b.tasks.arrival),
                 ("type_id", a.tasks.type_id, b.tasks.type_id),
                 ("deadline", a.tasks.deadline, b.tasks.deadline),
                 ("mtype", a.mtype, b.mtype),
                 ("eet", a.tables.eet, b.tables.eet),
                 ("power", a.tables.power, b.tables.power),
                 ("noise", a.tables.noise, b.tables.noise),
                 ("rank", a.tables.rank, b.tables.rank),
                 ("policy_ids", a.policy_ids, b.policy_ids),
                 ("parents", a.parents, b.parents)]
        for col in ("speed", "power_scale", "down_start", "down_end",
                    "kill"):
            pairs.append((col, getattr(a.dynamics, col),
                          getattr(b.dynamics, col)))
        for name, x, y in pairs:
            _same(x, y.numpy(), f"{name} R={n_replicas}")
        width = b.parents.shape[2]
        assert width == X._workflow_kmax(jspec) == TX._workflow_kmax(tspec)
        assert width == 22                # fork_join at 24 tasks


@pytest.fixture(scope="module")
def exact_runs():
    """The workflow grid with exact products through the reference's
    compiled sweep, the reference's summary evaluated outside it, and
    the port."""
    jspec, tspec = _specs()
    reps = X.normalize(jspec)
    tb, dyn = reps.tables, reps.dynamics

    def pow2(x):
        return jnp.exp2(jnp.round(jnp.log2(x)))

    reps = reps._replace(
        tables=dataclasses.replace(tb, power=pow2(tb.power),
                                   noise=jnp.ones_like(tb.noise)),
        dynamics=dataclasses.replace(dyn, speed=pow2(dyn.speed),
                                     power_scale=pow2(dyn.power_scale)))
    jres = X.run_experiment(jspec, replicas=reps)
    sj = E.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                     E.SimParams(), reps.dynamics, None, reps.parents)
    eager = jax.vmap(X.summarize_replica)(sj, reps.tables, reps.dynamics)
    treps = interop.replicas_from_numpy(reps.tasks, reps.mtype, reps.tables,
                                        reps.policy_ids, reps.dynamics,
                                        reps.parents, device="cpu")
    return sj, jres, eager, TX.run_experiment(tspec, device="cpu",
                                              replicas=treps)


def test_workflow_state_bitwise_on_exact_products(exact_runs):
    sj, _, _, tres = exact_runs
    st = tres.state
    for group, names in (("tasks", ("status", "machine", "seq", "t_start",
                                    "t_end")),
                         ("machines", ("busy_until", "active_time",
                                       "energy"))):
        for name in names:
            _same(getattr(getattr(sj, group), name),
                  getattr(getattr(st, group), name).numpy(), name)
    for name in ("time", "n_events", "n_live", "n_batch", "deps_left",
                 "n_preempts", "mq_count"):
        _same(getattr(sj, name), getattr(st, name).numpy(), name)


def test_workflow_summaries_bitwise_on_exact_products(exact_runs):
    """Against the compiled sweep every column bitwise but the three XLA
    may sum in another order; against the summary evaluated outside it
    every column bitwise but ``completion_rate``, which the compiler
    computes as ``completed * (1 / n)`` (the port's expression) and the
    eager evaluation as ``completed / n``: the two differ at n = 24."""
    _, jres, eager, tres = exact_runs
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        c = np.asarray(eager[k])
        assert a.dtype == b.dtype == c.dtype, k
        if k != "completion_rate":
            assert c.tobytes() == b.tobytes(), k
        if k in VECTORIZED:
            np.testing.assert_allclose(a, b, rtol=2**-22, err_msg=k)
        else:
            assert a.tobytes() == b.tobytes(), k
    keys = ("completion_rate", "missed", "cancelled", "preempted",
            "requeues", "active_energy", "makespan", "mean_response")
    assert jres.by_policy(keys) == tres.by_policy(keys)
    # the grid exercises what workflow mode adds: cascade cancels and,
    # on the failing cells, evictions
    assert tres.metrics["cancelled"].sum() > 0
    assert tres.metrics["requeues"].sum() + tres.metrics["preempted"].sum() \
        > 0


def test_workflow_natural_draws_counts_exact_floats_close():
    jspec, tspec = _specs(n_replicas=30, seed=9)
    jres = X.run_experiment(jspec)
    tres = TX.run_experiment(tspec, device="cpu")
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        assert a.dtype == b.dtype, k
        if k in COUNTS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
