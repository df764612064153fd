"""The port's oracle (``repro_torch.core.ref_engine``) against the JAX
package's, and the port's engine against the port's oracle.

1. ``simulate_ref`` of both packages on the same numpy inputs: every
   ``RefResult`` field equal, with no tolerance (arrays bitwise, the
   trace list row for row, the metrics dict key for key).  Instances:
   ``tests/conftest.py::make_instance`` fleets with fail/repair traces,
   spot kills and DVFS states, a heterogeneous DVFS fleet, a static
   fleet, a workflow under failures, and the learned policies; trace on
   and off; metrics off, with the default spec and with an odd spec; the
   streaming window ``window=W`` below N.
2. The port's engine against the port's oracle, as
   ``tests/test_scenarios.py``, ``test_trace.py``, ``test_metrics.py``
   and ``test_streaming.py`` hold the JAX engine to its oracle, with
   their tolerances: statuses, machines and evictions equal, start and
   end times to rtol 1e-5 / atol 1e-4, energy to rtol 1e-4 / atol 1e-2,
   trace rows equal but for times within 1e-3, metrics counts equal;
   dense (``engine.simulate``) and streaming (``streaming.simulate_stream``
   with N > W).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from conftest import make_instance

from repro.core import neural as JN
from repro.core import ref_engine as R
from repro.core.workload import chain_workflow, make_scenario
from repro_torch.core import metrics as TME
from repro_torch.core import ref_engine as TR
from repro_torch.core import state as TS
from repro_torch.core import streaming as TST
from repro_torch.core import trace as TT
from repro_torch.core import workload as TW
from repro_torch.core import engine as TE
from repro_torch.core.eet import EETTable

pytestmark = pytest.mark.torch

HEURISTICS = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
              "maxmin", "edf_mct", "heft")
POLICIES = HEURISTICS + ("mlp", "linear")
ODD_SPEC = TME.MetricsSpec(buckets=7, lo=0.05, hi=40.0, slo_target=2.5,
                           windows=5, window_s=3.0)


def _static(wl, m):
    return None


def _hetero(wl, m):
    return dict(speed=np.array([1.0, 0.6, 1.2, 2.0][:m]),
                power_scale=np.array([1.0, 0.3, 1.6, 2.0][:m]),
                down_start=np.full((m, 1), np.inf),
                down_end=np.full((m, 1), np.inf), kill=np.zeros(m, bool))


def _scen(**kw):
    def build(wl, m):
        s = make_scenario(wl, m, **kw)
        return dict(speed=s.speed, power_scale=s.power_scale,
                    down_start=s.down_start, down_end=s.down_end,
                    kill=s.kill)
    return build


# name: (make_instance kwargs, fleet dynamics builder)
CASES = {
    "fail_repair": (dict(seed=17, n_tasks=24, n_machines=4),
                    _scen(fail_rate=0.15, mttr=3.0, spot=False,
                          dvfs="powersave", n_intervals=3, seed=7)),
    "spot_kill": (dict(seed=23, n_tasks=20, n_machines=3, rate=4.0,
                       slack=5.0),
                  _scen(fail_rate=0.3, mttr=2.0, spot=True, dvfs="turbo",
                        n_intervals=4, seed=9)),
    "hetero_dvfs": (dict(seed=29, n_tasks=20, n_machines=3, slack=5.0),
                    _hetero),
    "static": (dict(seed=42), _static),
}


def _instance(case):
    kw, build = CASES[case]
    eet, power, wl, mtype = make_instance(**kw)
    return eet, power, wl, mtype, build(wl, len(mtype)) or {}


def _weights(policy):
    if policy not in ("mlp", "linear"):
        return {}
    return {"policy_params": JN.params_to_numpy(JN.init_params(3))}


def assert_results_equal(got, want, what):
    """Every ``RefResult`` field of ``got`` (the port) equals ``want``
    (the reference), with no tolerance."""
    assert [f.name for f in dataclasses.fields(TR.RefResult)] \
        == [f.name for f in dataclasses.fields(R.RefResult)]
    for f in dataclasses.fields(R.RefResult):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "trace":
            assert (a is None) == (b is None), what
            if b is not None:
                assert a == b, f"{what}: trace rows differ"
        elif f.name == "metrics":
            assert (a is None) == (b is None), what
            if b is not None:
                assert a.keys() == b.keys(), what
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{what} {k}")
        else:
            assert type(a) is type(b) or (np.asarray(a).dtype
                                           == np.asarray(b).dtype), \
                f"{what} {f.name}"
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f.name}")


def _both(case, policy, **kw):
    eet, power, wl, mtype, dyn = _instance(case)
    args = (wl.arrival, wl.type_id, wl.deadline, eet.eet, power, mtype)
    kw = dict(lcap=3, **dyn, **_weights(policy), **kw)
    return (TR.simulate_ref(*args, policy=policy, **kw),
            R.simulate_ref(*args, policy=policy, **kw))


# ---------------------------------------------------------------------------
# 1. The port's oracle equals the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(CASES))
def test_oracle_equals_reference(case, policy):
    """Trace and default metrics on, then both off, then an odd metrics
    spec with the trace: every field equal."""
    for kw in (dict(trace=True, metrics=True), {},
               dict(trace=True, metrics=True, metrics_spec=ODD_SPEC)):
        got, want = _both(case, policy, **kw)
        assert_results_equal(got, want, f"{case} {policy} {kw}")


@pytest.mark.parametrize("case", ["fail_repair", "spot_kill"])
def test_oracle_cases_evict(case):
    """The dynamic cases really evict work, so the parity above covers
    the availability phase and its trace rows."""
    kind = TT.EV_PREEMPT if case == "spot_kill" else TT.EV_REQUEUE
    rows = [r for p in HEURISTICS for r in _both(case, p, trace=True)[0].trace]
    assert any(r[1] == kind for r in rows), case


@pytest.mark.parametrize("policy", ("fcfs", "mct", "minmin", "maxmin",
                                    "ee_mct", "mlp"))
@pytest.mark.parametrize("case", ["fail_repair", "spot_kill", "static"])
def test_oracle_window_equals_reference(case, policy):
    """The streaming mirror (``window=W`` below N) on dynamic fleets,
    traced, with metrics."""
    for w in (4, 7):
        got, want = _both(case, policy, window=w, trace=True, metrics=True)
        assert_results_equal(got, want, f"{case} {policy} W={w}")


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("policy", ["heft", "minmin", "ee_mct"])
def test_oracle_workflow_under_failures_equals_reference(policy, window):
    eet, power, _, mtype = make_instance(7)
    wf = chain_workflow(30, 3, mean_eet=eet.eet.mean(1), slack_jitter=0.4,
                        seed=9)
    wl = wf.workload
    s = make_scenario(wl, len(mtype), fail_rate=0.1, mttr=2.0, spot=True,
                      dvfs="powersave", n_intervals=3, seed=4)
    kw = dict(policy=policy, lcap=3, parents=wf.parents,
              rank=wf.ranks(eet.eet.mean(1)), window=window, speed=s.speed,
              power_scale=s.power_scale, down_start=s.down_start,
              down_end=s.down_end, kill=s.kill, trace=True, metrics=True)
    args = (wl.arrival, wl.type_id, wl.deadline, eet.eet, power, mtype)
    assert_results_equal(TR.simulate_ref(*args, **kw),
                         R.simulate_ref(*args, **kw),
                         f"workflow {policy} W={window}")


def test_oracle_still_refuses_unknown_policies():
    eet, power, wl, mtype = make_instance(0)
    with pytest.raises(ValueError, match="unported policy"):
        TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                        power, mtype, policy="nope", trace=True)


# ---------------------------------------------------------------------------
# 2. The port's engine against the port's oracle
# ---------------------------------------------------------------------------
def _port_inputs(case):
    eet, power, wl, mtype, dyn = _instance(case)
    twl = TW.Workload(wl.arrival, wl.type_id, wl.deadline)
    dynamics = None
    if dyn:
        dynamics = TW.Scenario(workload=None, **dyn).dynamics(device="cpu")
    return eet, power, wl, mtype, dyn, twl, dynamics


def _rows(tb):
    ev = TT.events(TT.replica_trace(tb, 0))
    return list(zip(ev["time"].tolist(), ev["kind"].tolist(),
                    ev["task"].tolist(), ev["machine"].tolist()))


def assert_streams_match(rows, ref_rows, what):
    """``tests/test_trace.py``'s assertion: kinds, tasks and machines
    equal row for row, times within 1e-3."""
    assert ref_rows is not None
    assert len(rows) == len(ref_rows), (
        f"row count {what}: engine {len(rows)} oracle {len(ref_rows)}")
    for i, (a, b) in enumerate(zip(rows, ref_rows)):
        assert a[1:] == b[1:], f"row {i} {what}: {a} vs {b}"
        assert abs(a[0] - b[0]) < 1e-3, f"row {i} time {what}: {a} vs {b}"


def _port_weights(policy):
    from repro_torch import interop
    w = _weights(policy)
    return {"policy_params": interop.policy_params_from_numpy(
        w["policy_params"], "cpu")} if w else {}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["fail_repair", "spot_kill",
                                  "hetero_dvfs"])
def test_engine_matches_port_oracle_dense(case, policy):
    """``engine.simulate`` with the trace and the metrics against the
    port's oracle on the same dynamic fleet."""
    eet, power, wl, mtype, dyn, twl, dynamics = _port_inputs(case)
    spec = ODD_SPEC if case == "spot_kill" else None
    st = TE.simulate(twl, EETTable(eet.eet), power, mtype, policy=policy,
                     lcap=3, dynamics=dynamics, trace=True, metrics=True,
                     metrics_spec=spec, device="cpu",
                     **_port_weights(policy))
    ref = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                          power, mtype, policy=policy, lcap=3, **dyn,
                          trace=True, metrics=True, metrics_spec=spec,
                          **_weights(policy))
    what = f"{case} {policy}"
    t = st.tasks
    np.testing.assert_array_equal(t.status[0].numpy(), ref.status, what)
    np.testing.assert_array_equal(t.machine[0].numpy(), ref.machine, what)
    np.testing.assert_array_equal(st.n_preempts[0].numpy(), ref.n_preempts,
                                  what)
    np.testing.assert_allclose(t.t_start[0].numpy(), ref.t_start,
                               rtol=1e-5, atol=1e-4, err_msg=what)
    np.testing.assert_allclose(t.t_end[0].numpy(), ref.t_end, rtol=1e-5,
                               atol=1e-4, err_msg=what)
    np.testing.assert_allclose(st.machines.energy[0].numpy(),
                               ref.active_energy, rtol=1e-4, atol=1e-2,
                               err_msg=what)
    assert int(st.n_events[0]) == ref.n_events, what
    assert_streams_match(_rows(st.trace), ref.trace, what)
    counts = TME.to_numpy(st.metrics, replica=0)
    assert counts.keys() == ref.metrics.keys()
    for k in counts:
        np.testing.assert_array_equal(counts[k], ref.metrics[k],
                                      err_msg=f"{what} {k}")


@pytest.mark.parametrize("policy", ["fcfs", "mct", "minmin", "ee_mct",
                                    "heft", "linear"])
@pytest.mark.parametrize("case", ["fail_repair", "static"])
def test_stream_matches_port_oracle_window(case, policy):
    """``streaming.simulate_stream`` with N > W against the port's
    oracle's window mirror, as ``tests/test_streaming.py`` holds the
    reference: outcome counts, makespan and energy, and the trace."""
    eet, power, wl, mtype, dyn, twl, dynamics = _port_inputs(case)
    res = TST.simulate_stream(twl, EETTable(eet.eet), power, mtype,
                              policy=policy, window=6, chunk=7, lcap=3,
                              dynamics=dynamics, trace=True, device="cpu",
                              **_port_weights(policy))
    ref = TR.simulate_ref(wl.arrival, wl.type_id, wl.deadline, eet.eet,
                          power, mtype, policy=policy, lcap=3, **dyn,
                          trace=True, window=6, **_weights(policy))
    s = res.summarize()
    what = f"{case} {policy}"
    assert s["retired"] == wl.n_tasks and not res.stalled, what
    assert s["completed"] == int((ref.status == TS.COMPLETED).sum()), what
    assert s["cancelled"] == int((ref.status == TS.CANCELLED).sum()), what
    assert s["missed"] == int(np.isin(
        ref.status, (TS.MISSED_QUEUE, TS.MISSED_RUNNING)).sum()), what
    np.testing.assert_allclose(s["makespan"], ref.makespan, rtol=1e-5,
                               atol=1e-4, err_msg=what)
    np.testing.assert_allclose(s["active_energy_J"],
                               ref.active_energy.sum(), rtol=1e-4,
                               atol=1e-2, err_msg=what)
    assert_streams_match(_rows(res.trace), ref.trace, what)
