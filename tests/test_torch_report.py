"""The port's report functions, visual renderers and trace files against
the JAX package's, string for string.

One traced run with metrics of the batch of ``tests/test_torch_trace.py``
(all ten policies on flat, dynamic-fleet and workflow instances) on both
sides; its replicas are bitwise equal (``test_torch_trace.py``), so
every report row, table, ASCII Gantt chart, SVG chart and HTML page the
port renders from a replica must equal the JAX one rendered from the
same replica: the flat, requeue, spot and workflow instances, with the
down intervals shaded and the DAG's arrows and critical path drawn.
The E2C trace files load bit-equal to the JAX parser (header or not,
type names, synthesized deadlines) and save to the same text.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
from test_torch_drain_kway import POLICIES, jax_run, mixed_batch, port_run
from test_torch_trace import traced

from repro.core import report as JR
from repro.core import viz as JV
from repro.core import workload as JW
from repro_torch import interop
from repro_torch.core import report as TR
from repro_torch.core import viz as TV
from repro_torch.core import workload as TW

pytestmark = pytest.mark.torch

# replicas of the batch: flat, requeue, spot, DAG, DAG under failures
CASES = (3, 16, 27, 38, 46)


@pytest.fixture(scope="module")
def runs():
    batch = mixed_batch()
    jp, tp = traced()
    sj = jax_run(batch, jp)
    st = port_run(batch, tp)
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    return batch, sj, st, reps


def _one(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def _jax_case(runs, i):
    batch, sj, _, _ = runs
    return _one(sj, i), _one(batch[2], i), _one(batch[4], i), \
        np.asarray(batch[5][i])


@pytest.mark.parametrize("i", CASES)
def test_report_functions_match_jax(runs, i):
    _, _, st, reps = runs
    sj1, tab, dyn, _ = _jax_case(runs, i)
    assert TR.trace_table(st, i) == JR.trace_table(sj1)
    assert TR.trace_table(st.trace, i) == JR.trace_table(sj1.trace)
    assert TR.task_table(st, i) == JR.task_table(sj1)
    assert TR.ascii_gantt(st, replica=i) == JR.ascii_gantt(sj1)
    assert TR.ascii_gantt(st, 40, replica=i) == JR.ascii_gantt(sj1, 40)
    rep = TR.metrics(st, reps.tables, i, reps.dynamics)
    assert TR.format_report(rep) == JR.format_report(
        JR.metrics(sj1, tab, dyn))
    assert TR.summarize(st, reps.tables, i, reps.dynamics) == \
        JR.summarize(sj1, tab, dyn)
    assert "resp_p99" in TR.summarize(st, reps.tables, i)


@pytest.mark.parametrize("i", CASES)
def test_viz_charts_match_jax(runs, i):
    _, _, st, reps = runs
    sj1, _, dyn, parents = _jax_case(runs, i)
    dag = i >= 30
    want = JV.gantt(sj1, dynamics=dyn)
    assert TV.gantt(st, dynamics=reps.dynamics, replica=i) == want
    d = reps.dynamics
    scen = TW.Scenario(TW.Workload(*(np.zeros(1),) * 3), d.speed[i],
                       d.power_scale[i], d.down_start[i].numpy(),
                       d.down_end[i].numpy(), d.kill[i])
    assert TV.gantt(st, dynamics=scen, replica=i) == want
    if dag:
        assert TV.gantt(st, workflow=reps.parents, replica=i) == \
            JV.gantt(sj1, workflow=parents)
        assert "critical path" in TV.gantt(st, workflow=reps.parents,
                                           replica=i)
    for tfn, jfn in ((TV.utilization, JV.utilization),
                     (TV.queue_depth, JV.queue_depth),
                     (TV.energy_over_time, JV.energy_over_time)):
        assert tfn(st, replica=i) == jfn(sj1)
    for a, b in zip(TV.busy_fraction(st, i), JV.busy_fraction(sj1)):
        assert a.tobytes() == b.tobytes()
    assert TV.metrics_dashboard(st.metrics, replica=i) == \
        JV.metrics_dashboard(sj1.metrics)
    rows = [{"policy": p, "energy": float(k + 1), "missed": 2.0 * k,
             "makespan": 10.0 - k} for k, p in enumerate(POLICIES)]
    want = JV.html_report(sj1, dynamics=dyn, scoreboard=rows,
                          workflow=parents if dag else None,
                          metrics=sj1.metrics, title=f"replica {i}")
    got = TV.html_report(st, dynamics=reps.dynamics, scoreboard=rows,
                         workflow=reps.parents if dag else None,
                         metrics=st.metrics, title=f"replica {i}",
                         replica=i)
    assert got == want
    assert got.count("<figure") == 6


def test_sweep_charts_and_save_match_jax(runs, tmp_path):
    _, sj, st, _ = runs
    for a, b in zip(TV.sweep_busy_curves(st.trace, 64),
                    JV.sweep_busy_curves(sj.trace, 64)):
        assert a.tobytes() == b.tobytes()
    svg = TV.sweep_utilization(st.trace)
    assert svg == JV.sweep_utilization(sj.trace)
    one = TV.replica_trace(st, 5)
    assert TV.utilization(one) == JV.utilization(JV.replica_trace(sj.trace,
                                                                  5))
    rows = [{"policy": p, "energy": 1.0 + k} for k, p in
            enumerate(POLICIES)]
    assert TV.policy_scoreboard(rows, ("energy",)) == \
        JV.policy_scoreboard(rows, ("energy",))
    assert TV.policy_scoreboard([]) == JV.policy_scoreboard([])
    path = TV.save(str(tmp_path / "out" / "u.svg"), svg)
    JV.save(str(tmp_path / "ref.svg"), svg)
    assert open(path).read() == open(tmp_path / "ref.svg").read() == svg


CSV_TEXTS = (
    "task_id,task_type,arrival_time,deadline\n0,1,0.5,3.25\n"
    "1,0,0.25,\n2,2,1.125,9\n",
    "0,gpu_job,0.3,\n1,cpu_job,0.1,2.7\n2,gpu_job,0.2,\n\n3,io,0.9\n",
    "0,1,2.0,5.0\n1,-1,1.0,4.5\n",
)


@pytest.mark.parametrize("text", CSV_TEXTS)
def test_load_workload_csv_matches_jax(text):
    for kw in ({}, {"mean_eet": np.array([2.0, 0.5, 1.5], np.float32),
                    "slack": 2.5}, {"n_task_types": 4}):
        got = TW.load_workload_csv(text, **kw)
        want = JW.load_workload_csv(text, **kw)
        for key in ("arrival", "type_id", "deadline"):
            a, b = getattr(got, key), getattr(want, key)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key


def test_save_workload_csv_round_trip(tmp_path):
    wl = TW.poisson_workload(37, rate=3.0, n_task_types=3,
                             mean_eet=np.array([1.0, 2.0, 0.5]), seed=4)
    jwl = JW.poisson_workload(37, rate=3.0, n_task_types=3,
                              mean_eet=np.array([1.0, 2.0, 0.5]), seed=4)
    TW.save_workload_csv(wl, str(tmp_path / "port.csv"))
    JW.save_workload_csv(jwl, str(tmp_path / "jax.csv"))
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    back = TW.load_workload_csv(str(tmp_path / "port.csv"))
    ref = JW.load_workload_csv(str(tmp_path / "jax.csv"))
    for key in ("arrival", "type_id", "deadline"):
        assert getattr(back, key).tobytes() == getattr(ref, key).tobytes()
    np.testing.assert_array_equal(back.type_id, wl.type_id)
    np.testing.assert_allclose(back.arrival, wl.arrival, atol=1e-6)
