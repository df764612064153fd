"""The port's dynamic-fleet engine against the JAX engine and the oracle.

The fixed instances of ``tests/test_scenarios.py`` (fail/repair,
spot kill, the Max-Min dynamic case and a heterogeneous DVFS fleet) go
through ``repro.core.engine.run_sweep`` and
``repro_torch.core.engine.run_sweep`` as one batch holding all ten
heuristics, twice over: once on exact-product inputs (powers-of-two
power table, DVFS pairs of powers of two, unit noise), where every field
of the final state must be bitwise equal, and once with the instance's
own power table and the named DVFS states, where integer fields must be
equal and floats equal to the oracle suite's tolerance (ROADMAP.md,
queue C, says why the reference's float bits may move there).  The
port's kernel wrappers run their plain versions on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_instance

from repro.core import engine as E
from repro.core import ref_engine as R
from repro.core import schedulers as P
from repro.core.workload import Scenario, make_scenario
from repro_torch import interop
from repro_torch.core import energy as TEN
from repro_torch.core import engine as TE
from repro_torch.core import report as TR
from repro_torch.core import state as TS
from repro_torch.core import workload as TW
from repro_torch.core.eet import EETTable

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
INT_FIELDS = (("tasks", "status"), ("tasks", "machine"), ("tasks", "seq"),
              (None, "n_preempts"), (None, "n_events"))
FLOAT_FIELDS = (("tasks", "t_start"), ("tasks", "t_end"),
                ("machines", "busy_until"), ("machines", "active_time"),
                ("machines", "energy"), (None, "time"))


def _exact_power(power):
    return np.exp2(np.round(np.log2(power))).astype(np.float32)


def _trace(wl, m, *, dvfs, **kw):
    return make_scenario(wl, m, dvfs=dvfs, **kw)


def _hetero(wl, m, dvfs):
    speed, power_scale = dvfs
    return Scenario(workload=wl, speed=np.array(speed),
                    power_scale=np.array(power_scale),
                    down_start=np.full((m, 1), np.inf),
                    down_end=np.full((m, 1), np.inf),
                    kill=np.zeros(m, bool))


# name: (instance args, scenario builder, exact DVFS, named DVFS)
CASES = {
    "fail_repair": (
        dict(seed=17, n_tasks=24, n_machines=4),
        lambda wl, m, dvfs: _trace(wl, m, dvfs=dvfs, fail_rate=0.15,
                                   mttr=3.0, spot=False, n_intervals=3,
                                   seed=7),
        (0.5, 0.25), "powersave"),
    "spot_kill": (
        dict(seed=23, n_tasks=20, n_machines=3, rate=4.0, slack=5.0),
        lambda wl, m, dvfs: _trace(wl, m, dvfs=dvfs, fail_rate=0.3,
                                   mttr=2.0, spot=True, n_intervals=4,
                                   seed=9),
        (2.0, 2.0), "turbo"),
    "maxmin_dynamic": (
        dict(seed=31, n_tasks=22, n_machines=4, rate=4.0),
        lambda wl, m, dvfs: _trace(wl, m, dvfs=dvfs, fail_rate=0.25,
                                   mttr=2.5, spot=True, n_intervals=3,
                                   seed=13),
        (0.5, 0.25), "powersave"),
    "hetero_dvfs": (
        dict(seed=29, n_tasks=20, n_machines=3, rate=3.0, slack=5.0),
        _hetero,
        ([1.0, 0.5, 2.0], [1.0, 0.25, 2.0]),
        ([1.0, 0.6, 1.2], [1.0, 0.3, 1.6])),
}


def _variants(case):
    """(label, eet, power, wl, mtype, scenario) of the exact-product and
    the named-DVFS variant of a case."""
    kw, build, exact, named = CASES[case]
    eet, power, wl, mtype = make_instance(**kw)
    m = kw["n_machines"]
    return [("exact", eet, _exact_power(power), wl, mtype,
             build(wl, m, exact)),
            ("named", eet, power, wl, mtype, build(wl, m, named))]


def _jax_batch(variants):
    reps = []
    for _, eet, power, wl, mtype, scen in variants:
        tables = E.make_tables(eet, power, wl.n_tasks)
        for p in POLICIES:
            reps.append((wl.to_task_table(), jnp.asarray(mtype, jnp.int32),
                         tables, jnp.int32(P.POLICY_IDS[p]),
                         scen.dynamics()))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *reps)


def _field(st, group, name):
    return getattr(st if group is None else getattr(st, group), name)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module", params=list(CASES))
def case_states(request):
    """Both variants of a case, all ten policies, through the JAX
    engine (Pallas off) and the port, on one batch each."""
    variants = _variants(request.param)
    batch = _jax_batch(variants)
    sj = E.run_sweep(*batch[:4], E.SimParams(), batch[4])
    reps = interop.replicas_from_numpy(*batch[:4], dynamics=batch[4],
                                       device="cpu")
    st = TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                      dynamics=reps.dynamics)
    return request.param, variants, sj, st


def _rows(variant_index, policy):
    return variant_index * len(POLICIES) + POLICIES.index(policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_scenario_bitwise_on_exact_products(case_states, policy):
    case, _, sj, st = case_states
    r = _rows(0, policy)
    for group, name in INT_FIELDS + FLOAT_FIELDS:
        a = np.asarray(_field(sj, group, name))[r]
        b = _field(st, group, name)[r].numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{case} {policy} {name}")


@pytest.mark.parametrize("policy", POLICIES)
def test_scenario_named_dvfs_ints_exact_floats_close(case_states, policy):
    """Named DVFS states and the instance's own power table: the port
    against the JAX engine (integer fields exact, floats to the oracle
    suite's tolerance) and against the plain-Python oracle with the
    oracle suite's assertions."""
    case, variants, sj, st = case_states
    r = _rows(1, policy)
    for group, name in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(_field(sj, group, name))[r],
            _field(st, group, name)[r].numpy(), err_msg=f"{case} {name}")
    for group, name in FLOAT_FIELDS:
        np.testing.assert_allclose(
            np.asarray(_field(sj, group, name))[r],
            _field(st, group, name)[r].numpy(), rtol=1e-5, atol=1e-4,
            err_msg=f"{case} {policy} {name}")
    _, eet, power, wl, mtype, scen = variants[1]
    ref = R.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                         power, mtype, policy=policy, lcap=4,
                         speed=scen.speed, power_scale=scen.power_scale,
                         down_start=scen.down_start,
                         down_end=scen.down_end, kill=scen.kill)
    np.testing.assert_array_equal(st.tasks.status[r].numpy(), ref.status)
    np.testing.assert_array_equal(st.tasks.machine[r].numpy(), ref.machine)
    np.testing.assert_array_equal(st.n_preempts[r].numpy(), ref.n_preempts)
    np.testing.assert_allclose(st.tasks.t_end[r].numpy(), ref.t_end,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(st.machines.energy[r].numpy(),
                               ref.active_energy, rtol=1e-4, atol=1e-2)


def test_scenario_cases_exercise_evictions(case_states):
    """The traces really evict work (requeues or kills) where they have
    down intervals, so the parity above covers the availability phase."""
    case, _, sj, st = case_states
    if case == "hetero_dvfs":
        assert int(st.n_preempts.sum()) == 0
    else:
        assert int(st.n_preempts.sum()) > 0, case
    assert bool((st.tasks.status >= TS.COMPLETED).all())


@pytest.fixture(scope="module")
def maxmin_pallas_states():
    """The Max-Min dynamic case through the JAX engine with its Pallas
    kernels on (interpret mode) against the port."""
    variants = _variants("maxmin_dynamic")
    batch = _jax_batch(variants)
    sj = E.run_sweep(*batch[:4], E.SimParams(pallas=True), batch[4])
    reps = interop.replicas_from_numpy(*batch[:4], dynamics=batch[4],
                                       device="cpu")
    st = TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                      dynamics=reps.dynamics)
    return sj, st


@pytest.mark.parametrize("policy", ["mct", "minmin", "maxmin"])
def test_scenario_bitwise_with_reference_pallas(maxmin_pallas_states,
                                                policy):
    sj, st = maxmin_pallas_states
    r = _rows(0, policy)
    for group, name in INT_FIELDS + FLOAT_FIELDS:
        np.testing.assert_array_equal(
            _bits(np.asarray(_field(sj, group, name))[r]),
            _bits(_field(st, group, name)[r].numpy()), err_msg=name)


def test_static_scenario_matches_static_engine():
    """A no-op dynamics changes nothing, and both equal the JAX run."""
    eet, power, wl, mtype = make_instance(5, 16, 3)
    twl = TW.Workload(wl.arrival, wl.type_id, wl.deadline)
    kw = dict(policy="mct", device="cpu")
    st_plain = TE.simulate(twl, EETTable(eet.eet), power, mtype, **kw)
    st_dyn = TE.simulate(twl, EETTable(eet.eet), power, mtype,
                         dynamics=TS.static_dynamics(3, device="cpu"), **kw)
    sj = E.simulate(wl, eet, power, mtype, policy="mct")
    for group, name in INT_FIELDS + FLOAT_FIELDS:
        a = _field(st_plain, group, name)[0].numpy()
        np.testing.assert_array_equal(
            _bits(a), _bits(_field(st_dyn, group, name)[0].numpy()),
            err_msg=name)
        np.testing.assert_array_equal(
            _bits(a), _bits(np.asarray(_field(sj, group, name))),
            err_msg=name)


# ---------------------------------------------------------------------------
# Closed-form preemption semantics (1 task, 1 machine), as in
# tests/test_scenarios.py
# ---------------------------------------------------------------------------
def _one_task(exec_s=10.0, deadline=100.0, n=1):
    eet = EETTable(np.array([[exec_s]], np.float32))
    power = np.array([[5.0, 50.0]], np.float32)
    wl = TW.Workload(np.zeros(n), np.zeros(n, np.int32),
                     np.full(n, deadline))
    return eet, power, wl


def _dyn(down, *, kill, speed=1.0, power_scale=1.0):
    down = np.asarray(down, np.float32).reshape(1, -1, 2)
    return TW.Scenario(workload=None, speed=np.array([speed]),
                       power_scale=np.array([power_scale]),
                       down_start=down[:, :, 0], down_end=down[:, :, 1],
                       kill=np.array([kill])).dynamics(device="cpu")


@pytest.mark.parametrize("kill", [False, True])
def test_preemption_closed_form(kill):
    """Down 4..6: requeue restarts from scratch (done at 16, energy 14 s
    of P_active); a kill ends PREEMPTED at 4 with 4 s charged."""
    eet, power, wl = _one_task()
    dyn = _dyn([[4.0, 6.0]], kill=kill)
    st = TE.simulate(wl, eet, power, [0], policy="mct", dynamics=dyn,
                     device="cpu")
    assert int(st.n_preempts[0, 0]) == 1
    tables = TE.make_tables(eet, power, 1, device="cpu")
    rep = TR.metrics(st, tables, dynamics=dyn)
    if kill:
        assert int(st.tasks.status[0, 0]) == TS.PREEMPTED
        assert float(st.tasks.t_end[0, 0]) == 4.0
        assert float(st.machines.energy[0, 0]) == 4.0 * 50.0
        assert (rep.preempted, rep.requeues) == (1, 0)
    else:
        assert int(st.tasks.status[0, 0]) == TS.COMPLETED
        assert float(st.tasks.t_end[0, 0]) == 16.0
        assert float(st.machines.energy[0, 0]) == 14.0 * 50.0
        assert (rep.preempted, rep.requeues) == (0, 1)
    span = rep.makespan
    down = min(6.0, span) - min(4.0, span)
    np.testing.assert_allclose(rep.availability, 1.0 - down / span,
                               rtol=1e-6)


def test_queued_tasks_flushed_on_failure():
    eet, power, wl = _one_task(deadline=200.0, n=2)
    dyn = _dyn([[4.0, 6.0]], kill=False)
    st = TE.simulate(wl, eet, power, [0], policy="fcfs", dynamics=dyn,
                     device="cpu")
    assert bool((st.tasks.status == TS.COMPLETED).all())
    assert int(st.n_preempts.sum()) == 2
    assert sorted(st.tasks.t_end[0].tolist()) == [16.0, 26.0]


def test_dvfs_scales_exec_time_and_power():
    eet, power, wl = _one_task()
    dyn = _dyn([[np.inf, np.inf]], kill=False, speed=2.0, power_scale=1.5)
    st = TE.simulate(wl, eet, power, [0], policy="mct", dynamics=dyn,
                     device="cpu")
    assert float(st.tasks.t_end[0, 0]) == 5.0
    assert float(st.machines.energy[0, 0]) == 50.0 * 1.5 * 5.0


def test_downtime_and_availability_accounting():
    dyn = _dyn([[2.0, 5.0], [8.0, 30.0]], kill=False)
    span = torch.tensor([20.0])
    assert TEN.downtime(dyn, span).tolist() == [[15.0]]
    assert TEN.availability(dyn, span).tolist() == [[0.25]]
