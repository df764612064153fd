"""Host helpers of the sweep layer, and the deprecated constructors as thin
shims over :mod:`repro_torch.launch.experiment`.

The counterpart of ``repro.launch.sim``.  First-class here:

* :func:`make_replicas`: the base independent-replica constructor (the
  spec's ``normalize``, as the legacy 4-tuple);
* :func:`run_grouped_sweep`: one ``run_sweep`` per policy group,
  stitched back in replica order;
* :func:`trace_replica`: re-run one replica of a stacked sweep with the
  trace on.

The reference's deprecated constructors (``build_sim_sweep``,
``build_scenario_sweep``, ``build_traced_sweep``,
``jitted_scenario_sweep``, ``make_scenario_replicas``,
``make_workflow_replicas``) delegate to the spec pipeline and emit one
``DeprecationWarning`` per process each; the sweep shims return plain
callables where the reference returns jitted ones.  ``learned=True``
adds the reference's trailing ``policy_params`` argument (shared
``neural.PolicyParams``) to a sweep shim, and ``run_grouped_sweep``
takes them as ``policy_params=``; the mesh-sharded
``build_sharded_sweep`` waits for the launch layer of queue A item 17.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import state as S
from repro_torch.launch.experiment import (ExperimentSpec, FleetAxis,
                                           PolicyAxis, Replicas,
                                           ScenarioAxis, WorkloadAxis,
                                           normalize, summarize_replica)

__all__ = [
    "summarize_replica", "build_sim_sweep", "build_scenario_sweep",
    "build_traced_sweep", "jitted_scenario_sweep", "trace_replica",
    "run_grouped_sweep", "make_replicas", "make_scenario_replicas",
    "make_workflow_replicas",
]

_WARNED: set[str] = set()


def _deprecated(name: str, hint: str) -> None:
    """One ``DeprecationWarning`` per shim per process (tests reset
    it through ``_WARNED``)."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"launch.sim.{name} is deprecated: build an ExperimentSpec and "
        f"use repro_torch.launch.experiment.{hint} instead "
        f"(docs/experiments.md)", DeprecationWarning, stacklevel=3)


def _sweep(params: E.SimParams):
    """``f(tasks, mtype, tables, policy_ids, dynamics, parents,
    policy_params) -> metrics``, or ``(metrics, traces)`` with
    ``params.trace``: the stacked inputs run on their device and
    summarized there (the plain counterpart of the reference's
    ``compile_sweep``)."""
    def sweep(tasks, mtype, tables, policy_ids, dynamics=None,
              parents=None, policy_params=None):
        st = E.run_sweep(tasks, mtype, tables, policy_ids, params,
                         dynamics=dynamics, parents=parents,
                         policy_params=policy_params)
        m = summarize_replica(st, tables, dynamics)
        return (m, st.trace) if params.trace else m
    return sweep


# ---------------------------------------------------------------------------
# Sweep constructors (deprecated shims)
# ---------------------------------------------------------------------------
def build_sim_sweep(n_tasks: int, n_machines: int,
                    params: E.SimParams = E.SimParams(),
                    learned: bool = False, workflow: bool = False):
    """DEPRECATED shim: ``f(tasks, mtype, tables, policy_ids[, parents]
    [, policy_params]) -> metrics`` (the legacy argument orders;
    ``learned`` takes precedence over ``workflow``, as in the
    reference)."""
    _deprecated("build_sim_sweep", "run_experiment")
    fn = _sweep(params)
    if learned:
        return lambda tt, mt, tb, pid, pp: fn(tt, mt, tb, pid,
                                              policy_params=pp)
    if workflow:
        return lambda tt, mt, tb, pid, par: fn(tt, mt, tb, pid, None, par)
    return lambda tt, mt, tb, pid: fn(tt, mt, tb, pid)


def build_scenario_sweep(n_tasks: int, n_machines: int,
                         params: E.SimParams = E.SimParams(),
                         learned: bool = False, workflow: bool = False):
    """DEPRECATED shim: ``f(tasks, mtype, tables, policy_ids, dynamics[,
    parents][, policy_params]) -> metrics`` (the legacy argument
    orders)."""
    _deprecated("build_scenario_sweep", "run_experiment")
    fn = _sweep(params)
    if learned and workflow:
        return lambda tt, mt, tb, pid, dyn, par, pp: fn(tt, mt, tb, pid,
                                                        dyn, par, pp)
    if learned:
        return lambda tt, mt, tb, pid, dyn, pp: fn(tt, mt, tb, pid, dyn,
                                                   policy_params=pp)
    if workflow:
        return lambda tt, mt, tb, pid, dyn, par: fn(tt, mt, tb, pid, dyn,
                                                    par)
    return lambda tt, mt, tb, pid, dyn: fn(tt, mt, tb, pid, dyn)


def build_traced_sweep(n_tasks: int, n_machines: int,
                       params: E.SimParams = E.SimParams()):
    """DEPRECATED shim: ``f(tasks, mtype, tables, policy_ids[,
    dynamics]) -> (metrics, traces)``, the batched ``TraceBuffer``."""
    _deprecated("build_traced_sweep",
                "run_experiment with ExperimentSpec(trace=True)")
    fn = _sweep(dataclasses.replace(params, trace=True))
    return lambda tt, mt, tb, pid, dynamics=None: fn(tt, mt, tb, pid,
                                                     dynamics)


_SWEEP_CACHE: dict = {}


def jitted_scenario_sweep(n_tasks: int, n_machines: int,
                          params: E.SimParams = E.SimParams(),
                          learned: bool = False):
    """DEPRECATED shim: ``f(tasks, mtype, tables, policy_ids, dynamics[,
    policy_params]) -> metrics``, one callable per (shape, params,
    learned) key, as the reference keeps its identity stable."""
    _deprecated("jitted_scenario_sweep", "run_experiment")
    key = (n_tasks, n_machines, params, learned)
    if key not in _SWEEP_CACHE:
        fn = _sweep(params)
        _SWEEP_CACHE[key] = (
            (lambda tt, mt, tb, pid, dyn, pp: fn(tt, mt, tb, pid, dyn,
                                                 policy_params=pp))
            if learned else
            (lambda tt, mt, tb, pid, dyn: fn(tt, mt, tb, pid, dyn)))
    return _SWEEP_CACHE[key]


def trace_replica(inputs, i: int, params: E.SimParams = E.SimParams(),
                  trace: bool = True) -> S.SimState:
    """Re-run replica ``i`` of a stacked sweep input with the trace on,
    on the inputs' device; returns its one-replica final state (leading
    axis 1), whose ``.trace`` feeds ``core/viz.py``.  ``inputs`` is a
    legacy 4/5/6-tuple or an ``experiment.Replicas``."""
    if isinstance(inputs, Replicas):
        inputs = inputs.legacy()
    rep = [x.take(slice(i, i + 1)) if isinstance(x, S._Batched)
           else x[i:i + 1] for x in inputs]
    dyn = rep[4] if len(rep) > 4 else None
    par = rep[5] if len(rep) > 5 else None
    return E.run_sweep(rep[0], rep[1], rep[2], rep[3],
                       dataclasses.replace(params, trace=trace),
                       dynamics=dyn, parents=par)


# ---------------------------------------------------------------------------
# Policy-grouped execution
# ---------------------------------------------------------------------------
def run_grouped_sweep(inputs, params: E.SimParams = E.SimParams(),
                      policy_params=None) -> dict:
    """One ``run_sweep`` per distinct policy id, each group's summaries
    stitched back into replica order: (R,) columns on the inputs'
    device.  ``inputs`` is a flat ``Replicas`` or a legacy 4-tuple;
    ``policy_params`` (shared ``neural.PolicyParams``) supplies the
    learned policies' weights."""
    if isinstance(inputs, Replicas):
        if inputs.dynamics is not None or inputs.parents is not None:
            raise ValueError(
                "run_grouped_sweep only supports flat replicas; this "
                "Replicas carries dynamics/parents — use "
                "experiment.run_experiment for scenario/workflow grids")
        inputs = inputs.legacy()
    tt, mt, tb, pids = inputs
    pids_np = pids.cpu().numpy()
    merged: dict = {}
    for pid in np.unique(pids_np):
        sel = torch.as_tensor(np.nonzero(pids_np == pid)[0],
                              device=pids.device)
        st = E.run_sweep(tt.take(sel), mt[sel], tb.take(sel), pids[sel],
                         params, policy_params=policy_params)
        for k, col in summarize_replica(st, tb.take(sel)).items():
            if k not in merged:
                merged[k] = torch.zeros(pids.shape, dtype=col.dtype,
                                        device=col.device)
            merged[k][sel] = col
    return merged


# ---------------------------------------------------------------------------
# Replica constructors (shims over experiment.normalize)
# ---------------------------------------------------------------------------
def make_replicas(n_replicas: int, n_tasks: int, n_machines: int,
                  n_task_types: int = 4, n_machine_types: int = 4, *,
                  policies: list[str] | None = None, rate: float = 4.0,
                  seed: int = 0, device="cuda") -> tuple:
    """Replicas of workloads x policies x EET draws on ``device``, as
    the legacy ``(tasks, mtype, tables, policy_ids)`` tuple."""
    policies = policies or ["fcfs", "met", "mct", "minmin", "ee_mct"]
    spec = ExperimentSpec(
        n_replicas, FleetAxis(n_machines, n_machine_types),
        WorkloadAxis(n_tasks, n_task_types, rate),
        policy=PolicyAxis(tuple(policies)), seed=seed)
    return normalize(spec, device).legacy()


def make_scenario_replicas(n_replicas: int, n_tasks: int, n_machines: int,
                           n_task_types: int = 4, n_machine_types: int = 4,
                           *, policies: list[str] | None = None,
                           fail_rates: list[float] | None = None,
                           dvfs_states: list[str] | None = None,
                           arrivals: tuple[str, ...] | None = None,
                           spot_frac: float = 0.5, mttr: float = 4.0,
                           n_intervals: int = 4, rate: float = 4.0,
                           seed: int = 0, device="cuda") -> tuple:
    """DEPRECATED shim: ``normalize`` with a ``ScenarioAxis`` (failure
    rate x DVFS x policy [x arrival] grid), as the legacy ``(tasks,
    mtype, tables, policy_ids, dynamics)`` tuple."""
    _deprecated("make_scenario_replicas",
                "normalize with ExperimentSpec(scenario=ScenarioAxis(...))")
    policies = policies or ["mct", "minmin", "ee_mct"]
    fail_rates = fail_rates if fail_rates is not None else [0.0, 0.05, 0.2]
    dvfs_states = dvfs_states or ["nominal", "powersave"]
    spec = ExperimentSpec(
        n_replicas, FleetAxis(n_machines, n_machine_types),
        WorkloadAxis(n_tasks, n_task_types, rate,
                     arrivals=None if arrivals is None else tuple(arrivals)),
        scenario=ScenarioAxis(tuple(fail_rates), tuple(dvfs_states),
                              spot_frac, mttr, n_intervals),
        policy=PolicyAxis(tuple(policies)), seed=seed)
    return normalize(spec, device).legacy()


def make_workflow_replicas(n_replicas: int, n_tasks: int, n_machines: int,
                           n_task_types: int = 4, n_machine_types: int = 4,
                           *, policies: list[str] | None = None,
                           shapes: tuple[str, ...] = ("chain", "fork_join",
                                                      "layered"),
                           fail_rates: list[float] | None = None,
                           dvfs_states: list[str] | None = None,
                           spot_frac: float = 0.0, mttr: float = 4.0,
                           n_intervals: int = 4, seed: int = 0,
                           device="cuda") -> tuple:
    """DEPRECATED shim: ``normalize`` in workflow mode (policies paired
    per DAG instance, parent tables padded to the grid's widest
    in-degree, HEFT ranks), as the legacy ``(tasks, mtype, tables,
    policy_ids, dynamics, parents)`` tuple."""
    _deprecated("make_workflow_replicas",
                "normalize with ExperimentSpec(WorkloadAxis(shapes=...))")
    policies = policies or ["heft", "mct", "rr"]
    fail_rates = fail_rates if fail_rates is not None else [0.0]
    dvfs_states = dvfs_states or ["nominal"]
    spec = ExperimentSpec(
        n_replicas, FleetAxis(n_machines, n_machine_types),
        WorkloadAxis(n_tasks, n_task_types, shapes=tuple(shapes)),
        scenario=ScenarioAxis(tuple(fail_rates), tuple(dvfs_states),
                              spot_frac, mttr, n_intervals),
        policy=PolicyAxis(tuple(policies)), seed=seed)
    return normalize(spec, device).legacy()
