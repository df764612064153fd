"""The port's flat experiment layer against ``repro.launch.experiment``.

``normalize`` must draw bit-equal replicas.  On replicas whose energy
products are exact (unit noise, powers-of-two power table) every summary
column and the ``by_policy`` rows must be bitwise equal; on the spec's
own draws the reference's float bits depend on where its compiler fuses
multiply-adds (ROADMAP.md, queue C), so there the count columns are held
exactly and the float columns to the oracle suite's tolerance.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from conftest import make_instance

from repro.core import engine as E
from repro.core import report as JR
from repro.launch import experiment as X
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import report as TR
from repro_torch.core.eet import EETTable
from repro_torch.core.workload import Workload
from repro_torch.launch import experiment as TX

pytestmark = pytest.mark.torch

POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")
COUNTS = ("completed", "missed", "cancelled", "preempted", "requeues")


def _specs(pallas):
    jspec = X.ExperimentSpec(20, X.FleetAxis(4), X.WorkloadAxis(48),
                             policy=X.PolicyAxis(POLICIES), seed=5,
                             pallas=pallas)
    tspec = TX.ExperimentSpec(20, TX.FleetAxis(4), TX.WorkloadAxis(48),
                              policy=TX.PolicyAxis(POLICIES), seed=5)
    return jspec, tspec


@pytest.fixture(scope="module")
def natural():
    jspec, tspec = _specs(False)
    return X.run_experiment(jspec), TX.run_experiment(tspec, device="cpu")


def test_normalize_bit_equal(natural):
    jres, tres = natural
    a, b = jres.replicas, tres.replicas
    pairs = [("arrival", a.tasks.arrival, b.tasks.arrival),
             ("type_id", a.tasks.type_id, b.tasks.type_id),
             ("deadline", a.tasks.deadline, b.tasks.deadline),
             ("mtype", a.mtype, b.mtype), ("eet", a.tables.eet, b.tables.eet),
             ("power", a.tables.power, b.tables.power),
             ("noise", a.tables.noise, b.tables.noise),
             ("rank", a.tables.rank, b.tables.rank),
             ("policy_ids", a.policy_ids, b.policy_ids)]
    for name, x, y in pairs:
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype, name
        assert x.tobytes() == y.tobytes(), name


def test_natural_draws_counts_exact_floats_close(natural):
    jres, tres = natural
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        assert a.dtype == b.dtype, k
        if k in COUNTS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
    rows_j, rows_t = jres.by_policy(), tres.by_policy()
    assert [r["policy"] for r in rows_j] == [r["policy"] for r in rows_t]
    assert [r["missed"] for r in rows_j] == [r["missed"] for r in rows_t]


def test_exact_products_by_policy_bitwise():
    """The reference's plain path against the port."""
    jspec, tspec = _specs(False)
    reps = X.normalize(jspec)
    tb = reps.tables
    exact = dataclasses.replace(
        tb, power=jnp.exp2(jnp.round(jnp.log2(tb.power))),
        noise=jnp.ones_like(tb.noise))
    reps = reps._replace(tables=exact)
    jres = X.run_experiment(jspec, replicas=reps)
    treps = interop.replicas_from_numpy(reps.tasks, reps.mtype, reps.tables,
                                        reps.policy_ids, device="cpu")
    tres = TX.run_experiment(tspec, device="cpu", replicas=treps)
    for k in jres.metrics:
        a, b = np.asarray(jres.metrics[k]), tres.metrics[k].numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert jres.by_policy() == tres.by_policy()


def test_report_summarize_row_matches():
    eet, power, wl, mtype = make_instance(42)
    sj = E.simulate(wl, eet, power, mtype, policy="mct")
    st = TE.simulate(Workload(wl.arrival, wl.type_id, wl.deadline),
                     EETTable(eet.eet), power, mtype, policy="mct",
                     device="cpu")
    tables = E.make_tables(eet, power, wl.n_tasks)
    ttables = TE.make_tables(eet, power, wl.n_tasks, device="cpu")
    assert JR.summarize(sj, tables) == TR.summarize(st, ttables)
    rj, rt = JR.metrics(sj, tables), TR.metrics(st, ttables)
    np.testing.assert_array_equal(rj.machine_util, rt.machine_util)


def test_unported_axes_raise():
    """A spec over the learned policies, which once refused to run, runs
    with shared weights (``learned=True``) and equals the reference's
    ``run_experiment`` with the same weights: the counts exactly, the
    float columns to the oracle suite's tolerance (the file's rule for a
    spec's own draws); only unknown arrival processes and policies
    raise."""
    from repro.core import neural as JN
    pp = JN.init_params(7)
    jspec, tspec = (lib.ExperimentSpec(
        4, lib.FleetAxis(3), lib.WorkloadAxis(12),
        policy=lib.PolicyAxis(("mlp", "linear")), learned=True, seed=4)
        for lib in (X, TX))
    want = X.run_experiment(jspec, policy_params=pp).metrics
    got = TX.run_experiment(tspec, device="cpu", policy_params=(
        interop.policy_params_from_numpy(JN.params_to_numpy(pp),
                                         "cpu"))).metrics
    for k in COUNTS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("completion_rate", "makespan", "energy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    assert TX.WorkloadAxis(8, arrivals=["bursty"]).arrivals == ("bursty",)
    with pytest.raises(ValueError, match="unknown arrival generators"):
        TX.WorkloadAxis(8, arrivals=("nope",))
    with pytest.raises(ValueError, match="unknown policies"):
        TX.PolicyAxis(("nope",))
