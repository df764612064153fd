"""The port's ``launch/sim.py`` host helpers against the JAX package.

The replica constructors must give the reference's legacy tuples bit for
bit; ``run_grouped_sweep`` the reference's columns and the port's own
``run_experiment`` columns; ``trace_replica`` the reference's trace rows
for the same replica.  The sweeps run on replicas whose products are
exact (unit noise, powers-of-two power tables and DVFS multipliers),
where the engines agree bitwise (ROADMAP.md, queue C).  Each deprecated
shim warns once a process and delegates to the spec pipeline; learned-
policy weights refuse to run.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trace as JT
from repro.launch import sim as JS
from repro_torch import interop
from repro_torch.core import trace as TT
from repro_torch.launch import experiment as TX
from repro_torch.launch import sim as TS

pytestmark = pytest.mark.torch


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _legacy_fields(tup) -> dict:
    """The drawn inputs of a legacy tuple of either package."""
    tasks, mtype, tables, pids = tup[:4]
    out = {"arrival": tasks.arrival, "type_id": tasks.type_id,
           "deadline": tasks.deadline, "mtype": mtype, "policy_ids": pids}
    for f in ("eet", "power", "noise", "rank"):
        out[f] = getattr(tables, f)
    if len(tup) > 4:
        for f in ("speed", "power_scale", "down_start", "down_end", "kill"):
            out[f] = getattr(tup[4], f)
    if len(tup) > 5:
        out["parents"] = tup[5]
    return {k: _np(v) for k, v in out.items()}


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _pow2(x):
    return jnp.exp2(jnp.round(jnp.log2(x)))


def _exact(tup):
    """A legacy tuple with exact products: unit noise, powers-of-two
    power tables and DVFS multipliers."""
    tasks, mtype, tb, pids = tup[:4]
    tb = dataclasses.replace(tb, power=_pow2(tb.power),
                             noise=jnp.ones_like(tb.noise))
    out = (tasks, mtype, tb, pids)
    if len(tup) > 4:
        dyn = tup[4]
        out += (dataclasses.replace(dyn, speed=_pow2(dyn.speed),
                                    power_scale=_pow2(dyn.power_scale)),)
    return out + tuple(tup[5:])


def _port(tup):
    reps = interop.replicas_from_numpy(*tup[:4], *tup[4:6], device="cpu")
    return reps.legacy()


@pytest.fixture
def fresh_warnings(monkeypatch):
    """Both packages' once-a-process warning registries, emptied for the
    test and restored after it."""
    monkeypatch.setattr(TS, "_WARNED", set())
    monkeypatch.setattr(JS, "_WARNED", set())


def test_make_replicas_bitwise_jax():
    kw = dict(policies=["mct", "minmin", "rr"], rate=3.0, seed=3)
    want = JS.make_replicas(12, 16, 4, 3, 2, **kw)
    got = TS.make_replicas(12, 16, 4, 3, 2, device="cpu", **kw)
    assert len(got) == len(want) == 4
    _same(_legacy_fields(got), _legacy_fields(want))


CONSTRUCTORS = {
    "scenario": ("make_scenario_replicas",
                 dict(fail_rates=[0.0, 0.3], dvfs_states=["turbo"],
                      arrivals=("poisson", "bursty"), seed=2)),
    "workflow": ("make_workflow_replicas",
                 dict(shapes=("chain", "fork_join"), fail_rates=[0.0, 0.2],
                      seed=4)),
}


@pytest.mark.parametrize("kind", sorted(CONSTRUCTORS))
def test_deprecated_constructors_bitwise_jax(kind, fresh_warnings):
    name, kw = CONSTRUCTORS[kind]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = getattr(JS, name)(18, 12, 4, **kw)
    with pytest.warns(DeprecationWarning, match=name):
        got = getattr(TS, name)(18, 12, 4, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = getattr(TS, name)(18, 12, 4, device="cpu", **kw)
    assert len(got) == len(want) == (5 if kind == "scenario" else 6)
    _same(_legacy_fields(got), _legacy_fields(want))
    _same(_legacy_fields(again), _legacy_fields(want))


def _flat_spec(lib):
    return lib.ExperimentSpec(10, lib.FleetAxis(4, 2), lib.WorkloadAxis(16, 3),
                              policy=lib.PolicyAxis(("mct", "minmin")),
                              seed=6)


def test_run_grouped_sweep_bitwise_jax_and_run_experiment():
    from repro.launch import experiment as X
    jreps = X.normalize(_flat_spec(X))
    legacy = _exact(jreps.legacy())
    want = JS.run_grouped_sweep(legacy)
    treps = interop.replicas_from_numpy(*legacy, device="cpu")
    got = TS.run_grouped_sweep(treps)
    mono = TX.run_experiment(_flat_spec(TX), device="cpu",
                             replicas=treps).metrics
    assert list(got) == list(mono) and set(got) == set(want)
    for k in want:
        assert got[k].dtype == mono[k].dtype and got[k].shape == (10,), k
        assert _np(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k
        assert torch.equal(got[k], mono[k]), k
    for k, col in TS.run_grouped_sweep(treps.legacy()).items():
        assert torch.equal(col, got[k]), k


def test_run_grouped_sweep_refusals():
    reps = TX.normalize(TX.ExperimentSpec(
        4, TX.FleetAxis(2), TX.WorkloadAxis(4),
        scenario=TX.ScenarioAxis()), device="cpu")
    with pytest.raises(ValueError, match="only supports flat replicas"):
        TS.run_grouped_sweep(reps)
    # the learned policies, once refused, group like any other: shared
    # weights, bitwise the reference's grouped sweep (tolerance 0 on the
    # counts; exact-product replicas, so the floats too)
    from repro.core import neural as JN
    from repro.launch import experiment as X
    legacy = _exact(X.normalize(X.ExperimentSpec(
        6, X.FleetAxis(3), X.WorkloadAxis(10),
        policy=X.PolicyAxis(("mlp", "mct", "linear")), seed=1)).legacy())
    pp = JN.init_params(5)
    want = JS.run_grouped_sweep(legacy, policy_params=pp)
    got = TS.run_grouped_sweep(
        interop.replicas_from_numpy(*legacy, device="cpu").legacy(),
        policy_params=interop.policy_params_from_numpy(
            JN.params_to_numpy(pp), "cpu"))
    for k in want:
        assert _np(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k


def test_trace_replica_rows_bitwise_jax(fresh_warnings):
    """Replica 5 of a dynamic-fleet grid re-run with the trace on: the
    reference's transition rows and snapshots, row by row."""
    kw = dict(policies=["ee_mct", "minmin"], fail_rates=[0.3],
              dvfs_states=["powersave"], seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = _exact(JS.make_scenario_replicas(8, 12, 4, **kw))
    want = JS.trace_replica(legacy, 5)
    got = TS.trace_replica(_port(legacy), 5)
    assert got.tasks.status.shape == (1, 12)
    je = JT.events(want.trace)
    pe = TT.events(TT.replica_trace(got.trace, 0))
    assert len(pe["time"]) == len(je["time"]) > 12
    for key in ("time", "kind", "task", "machine"):
        a, b = np.asarray(je[key]), np.asarray(pe[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    for f in ("snap_time", "snap_batch", "snap_mq", "snap_running",
              "snap_energy"):
        a = np.asarray(getattr(want.trace, f))
        b = getattr(got.trace, f)[0].numpy()
        assert a.tobytes() == b.tobytes(), f
    # a Replicas input takes its legacy view; trace=False runs untraced
    reps = interop.replicas_from_numpy(*legacy, device="cpu")
    again = TS.trace_replica(reps, 5)
    assert torch.equal(again.trace.ev_time, got.trace.ev_time)
    assert TS.trace_replica(reps, 5, trace=False).trace is None


# shim -> whether it takes machine dynamics
SHIMS = {"build_sim_sweep": False, "build_scenario_sweep": True,
         "jitted_scenario_sweep": True, "build_traced_sweep": False}


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_deprecated_sweep_shims(name, fresh_warnings):
    """Each shim warns once a process, and its callable gives the
    port's ``run_experiment`` columns; a traced build also returns the
    batched trace."""
    scenario = SHIMS[name]
    spec = TX.ExperimentSpec(
        6, TX.FleetAxis(4, 2), TX.WorkloadAxis(12, 3),
        scenario=TX.ScenarioAxis((0.0, 0.3)) if scenario else None,
        policy=TX.PolicyAxis(("mct", "rr")), seed=2)
    reps = TX.normalize(spec, device="cpu")
    want = TX.run_experiment(spec, device="cpu", replicas=reps)
    with pytest.warns(DeprecationWarning, match=name):
        fn = getattr(TS, name)(12, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = getattr(TS, name)(12, 4)
    if name == "jitted_scenario_sweep":
        assert again is fn
    out = fn(*reps.legacy())
    if name == "build_traced_sweep":
        out, traces = out
        assert traces.n_rows.shape == (6,) and int(traces.n_rows.min()) > 0
    assert list(out) == list(want.metrics)
    for k, col in out.items():
        assert torch.equal(col, want.metrics[k]), k
    if name != "build_traced_sweep":
        # learned=True takes the weights last (the reference's order);
        # the heuristics of these replicas ignore them
        from repro_torch.core import neural as TN
        pp = TN.init_params(1, device="cpu")
        out = getattr(TS, name)(12, 4, learned=True)(*reps.legacy(), pp)
        for k, col in out.items():
            assert torch.equal(col, want.metrics[k]), k


def test_workflow_sweep_shims(fresh_warnings):
    """``workflow=True`` takes the parent tables in the legacy argument
    order."""
    spec = TX.ExperimentSpec(
        4, TX.FleetAxis(4, 2), TX.WorkloadAxis(10, 3, shapes=("chain",)),
        policy=TX.PolicyAxis(("heft", "mct")), seed=3)
    reps = TX.normalize(spec, device="cpu")
    want = TX.run_experiment(spec, device="cpu", replicas=reps).metrics
    tt, mt, tb, pid, dyn, par = reps.legacy()
    with pytest.warns(DeprecationWarning):
        flat = TS.build_sim_sweep(10, 4, workflow=True)
    with pytest.warns(DeprecationWarning):
        scen = TS.build_scenario_sweep(10, 4, workflow=True)
    got_scen = scen(tt, mt, tb, pid, dyn, par)
    for k in want:
        assert torch.equal(got_scen[k], want[k]), k
    # without dynamics the fleet is static: the same run here, where the
    # workflow cells carry an inert failure trace
    got_flat = flat(tt, mt, tb, pid, par)
    for k in ("completed", "missed", "cancelled", "makespan"):
        assert torch.equal(got_flat[k], want[k]), k
