"""ExperimentSpec for flat and scenario sweeps: spec -> normalize -> run.

The counterpart of ``repro.launch.experiment`` for independent tasks and
workflows (DAGs) on a static or dynamic fleet: the same axes, the same
per-replica random draws, the same summary columns.

  spec       :class:`ExperimentSpec` — ``FleetAxis x WorkloadAxis x
             ScenarioAxis x PolicyAxis``, mixed radix over the replica
             index r: flat, policy ``r % n_p`` and arrival process
             ``(r // n_p) % n_a``; with a scenario axis, fail rate
             ``r % n_f``, DVFS state ``(r // n_f) % n_d``, policy
             ``(r // (n_f n_d)) % n_p`` and arrival process
             ``(r // (n_f n_d n_p)) % n_a``; in workflow mode
             (``WorkloadAxis(shapes=...)``) replicas come in *paired*
             cells: the ``n_p`` consecutive replicas of cell ``r // n_p``
             share one DAG, EET draw, fleet and failure trace and run
             policy ``r % n_p``; shape ``cell % n_s``, fail rate
             ``(cell // n_s) % n_f``, DVFS ``(cell // (n_s n_f)) % n_d``.
  normalize  :func:`normalize` — draw every replica (or workflow cell) on
             the host with numpy, from the reference's substreams in
             the reference's order, and hand the stacked tables to
             torch; parent tables pad to the grid's widest in-degree.
  execute    :func:`run_experiment` — normalize + ``engine.run_sweep`` +
             :func:`summarize_replica` on the device; with ``chunk=C``
             the grid runs C replicas at a time through
             ``launch/chunked.py`` into an exact on-device aggregate
             (:func:`normalize_chunk` draws any range of the grid
             alone, bitwise the slice of :func:`normalize`).

``ExperimentSpec(trace=True)`` records every replica's trace
(``ExperimentResult.traces``, the batched ``trace.TraceBuffer``), and
``metrics=True`` its histograms and SLO windows, which add the tail
columns ``resp/wait/slow/qdepth_p50/p95/p99`` to the summary, computed
on the device.  ``WorkloadAxis(streaming=W)`` runs every replica
through the bounded-memory window engine (``core/streaming.py``) with
the same draws and the same summary columns, computed from the running
aggregates (:func:`to_streams` packs the inputs).  The learned ``mlp``
and ``linear`` policies run like any other; ``run_experiment(spec,
policy_params=...)`` gives them their weights (``ExperimentSpec(
learned=True)`` declares that a spec takes them, as in the reference).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import energy as EN
from repro_torch.core import engine as E
from repro_torch.core import metrics as ME
from repro_torch.core import schedulers as P
from repro_torch.core import state as S
from repro_torch.core import streaming as ST
from repro_torch.core import telemetry as TL
from repro_torch.core.eet import synth_eet
from repro_torch.core.reduce import ordered_sum
from repro_torch.core.workload import (ARRIVAL_GENERATORS,
                                       WORKFLOW_GENERATORS, make_scenario,
                                       poisson_workload, resolve_arrivals,
                                       resolve_shapes, task_table)

__all__ = ["FleetAxis", "WorkloadAxis", "ScenarioAxis", "PolicyAxis",
           "ExperimentSpec", "Replicas", "ExperimentResult", "normalize",
           "normalize_chunk", "run_experiment", "summarize_replica",
           "to_streams"]


def summarize_replica(st: S.SimState, tables: S.StaticTables,
                      dynamics: S.MachineDynamics | None = None) -> dict:
    """(R,) summary columns of every replica, on the device.  With
    ``dynamics`` the availability is the mean over machines and downtime
    leaves the idle energy; a state that carries metrics adds the tail
    columns (``metrics.tail_columns``)."""
    status = st.tasks.status
    completed = (status == S.COMPLETED).sum(1, dtype=torch.int32)
    missed = ((status == S.MISSED_QUEUE) | (status == S.MISSED_RUNNING)
              ).sum(1, dtype=torch.int32)
    cancelled = (status == S.CANCELLED).sum(1, dtype=torch.int32)
    preempted = (status == S.PREEMPTED).sum(1, dtype=torch.int32)
    makespan = EN.makespan(st)
    active_e = ordered_sum(st.machines.energy, 1)
    idle_e = ordered_sum(EN.idle_energy(st, tables, dynamics), 1)
    n = status.shape[1]
    response = torch.where(status == S.COMPLETED,
                           st.tasks.t_end - st.tasks.arrival, 0.0)
    out = {
        "completed": completed, "missed": missed, "cancelled": cancelled,
        "preempted": preempted,
        "requeues": st.n_preempts.sum(1, dtype=torch.int32) - preempted,
        "availability": torch.ones_like(makespan) if dynamics is None
        else EN.mean_availability(EN.availability(dynamics, makespan)),
        # the reference's compiler turns the division by the constant n
        # into a multiplication by its float32 reciprocal
        "completion_rate": completed * torch.full(
            (), 1.0 / n, dtype=torch.float32, device=status.device),
        "makespan": makespan,
        "energy": active_e + idle_e,
        "active_energy": active_e,
        "idle_energy": idle_e,
        "mean_response": ordered_sum(response, 1)
        / torch.clamp(completed, min=1),
    }
    if st.metrics is not None:
        out.update(ME.tail_columns(st.metrics))
    return out


@dataclass(frozen=True)
class FleetAxis:
    """Fleet size and machine-type diversity; each replica draws its
    machine-type assignment and power table independently."""
    n_machines: int
    n_machine_types: int = 4


@dataclass(frozen=True)
class WorkloadAxis:
    """The task side: ``n_tasks`` tasks at ``rate``.  ``arrivals`` names
    ``workload.ARRIVAL_GENERATORS`` entries and makes the arrival process
    a grid axis (None = Poisson everywhere).  ``shapes`` names
    ``workload.WORKFLOW_GENERATORS`` entries and switches the experiment
    to workflow mode; the two are mutually exclusive.  ``streaming=W``
    runs every replica through the streaming engine with a W-slot window
    (memory O(W) a replica instead of O(n_tasks)), ``stream_chunk`` sets
    its chunk size (default ``min(n_tasks, W)``; results do not depend
    on it); streaming composes with ``arrivals`` and a scenario axis,
    not with ``shapes``."""
    n_tasks: int
    n_task_types: int = 4
    rate: float = 4.0
    arrivals: tuple[str, ...] | None = None
    shapes: tuple[str, ...] | None = None
    streaming: int | None = None
    stream_chunk: int | None = None

    def __post_init__(self):
        if self.arrivals is not None and self.shapes is not None:
            raise ValueError("WorkloadAxis takes arrivals OR shapes, not "
                             "both (DAG generators emit their own arrival "
                             "times)")
        if self.arrivals is not None:
            object.__setattr__(self, "arrivals",
                               resolve_arrivals(self.arrivals))
        if self.shapes is not None:
            object.__setattr__(self, "shapes", resolve_shapes(self.shapes))
        if self.streaming is not None:
            if self.shapes is not None:
                raise ValueError(
                    "streaming does not compose with shapes (workflow "
                    "cells pad parent tables across the grid); run DAGs "
                    "through streaming.simulate_stream directly")
            if self.streaming < 1:
                raise ValueError(f"streaming window must be >= 1, got "
                                 f"{self.streaming}")
        if self.stream_chunk is not None:
            if self.streaming is None:
                raise ValueError("stream_chunk requires streaming=W")
            if self.stream_chunk < 1:
                raise ValueError(f"stream_chunk must be >= 1, got "
                                 f"{self.stream_chunk}")


@dataclass(frozen=True)
class ScenarioAxis:
    """Machine dynamics grid: failure rates x DVFS states.  Eviction
    semantics is not a grid axis: each replica draws kill (spot) versus
    requeue as a Bernoulli(``spot_frac``)."""
    fail_rates: tuple[float, ...] = (0.0,)
    dvfs_states: tuple[str, ...] = ("nominal",)
    spot_frac: float = 0.0
    mttr: float = 4.0
    n_intervals: int = 4

    def __post_init__(self):
        object.__setattr__(self, "fail_rates", tuple(self.fail_rates))
        object.__setattr__(self, "dvfs_states", tuple(self.dvfs_states))


@dataclass(frozen=True)
class PolicyAxis:
    """Scheduling policies swept over replicas (``schedulers.POLICY_IDS``
    names)."""
    policies: tuple[str, ...] = ("mct",)

    def __post_init__(self):
        object.__setattr__(self, "policies", tuple(self.policies))
        unknown = [p for p in self.policies if p not in P.POLICY_IDS]
        if unknown:
            raise ValueError(f"unknown policies {unknown}; known: "
                             f"{sorted(P.POLICY_IDS)}")


@dataclass(frozen=True)
class ExperimentSpec:
    """One experiment: each replica draws its own EET table, power
    table, workload, noise, fleet and, with a ``scenario`` axis, machine
    dynamics; the grid cell of replica r follows the module docstring.
    ``trace`` and ``metrics`` fold into the effective ``sim_params``;
    ``learned=True`` declares that the run takes shared
    ``neural.PolicyParams`` (pass them to :func:`run_experiment`)."""
    n_replicas: int
    fleet: FleetAxis
    workload: WorkloadAxis
    scenario: ScenarioAxis | None = None
    policy: PolicyAxis = field(default_factory=PolicyAxis)
    sim: E.SimParams = field(default_factory=E.SimParams)
    trace: bool = False
    metrics: bool = False
    learned: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got "
                             f"{self.n_replicas}")

    @property
    def workflow(self) -> bool:
        return self.workload.shapes is not None

    @property
    def streaming(self) -> bool:
        return self.workload.streaming is not None

    @property
    def stream_params(self) -> ST.StreamParams:
        """The effective streaming parameters (streaming specs); as in
        the reference, ``sim.drain_k`` is not forwarded (the window
        drains one decision a trip)."""
        sp = self.sim_params
        return ST.StreamParams(
            window=self.workload.streaming, lcap=sp.lcap, qcap=sp.qcap,
            cancel_infeasible=sp.cancel_infeasible,
            max_events=sp.max_events, trace=sp.trace,
            trace_capacity=sp.trace_capacity, metrics=sp.metrics,
            metrics_spec=sp.metrics_spec)

    @property
    def stream_chunk(self) -> int:
        wk = self.workload
        return wk.stream_chunk or max(min(wk.n_tasks, wk.streaming), 1)

    @property
    def sim_params(self) -> E.SimParams:
        """The effective engine parameters, ``trace`` and ``metrics``
        folded in."""
        sp = self.sim
        if self.trace:
            sp = dataclasses.replace(sp, trace=True)
        if self.metrics:
            sp = dataclasses.replace(sp, metrics=True)
        return sp

    def with_(self, **kw) -> "ExperimentSpec":
        """Functional update: ``spec.with_(seed=1, trace=True)``."""
        return dataclasses.replace(self, **kw)


@dataclass
class Replicas:
    """Stacked per-replica inputs (leading axis R on every tensor)."""
    tasks: S.TaskTable
    mtype: torch.Tensor        # i32 (R, M)
    tables: S.StaticTables
    policy_ids: torch.Tensor   # i32 (R,)
    dynamics: S.MachineDynamics | None = None
    parents: torch.Tensor | None = None   # i32 (R, N, K), -1 padded

    @property
    def n_replicas(self) -> int:
        return int(self.policy_ids.shape[0])

    def legacy(self) -> tuple:
        """The positional tuple the pre-spec constructors gave: (tasks, mtype,
        tables, policy_ids), then dynamics and parents where present."""
        out = (self.tasks, self.mtype, self.tables, self.policy_ids)
        if self.dynamics is not None:
            out = out + (self.dynamics,)
        if self.parents is not None:
            out = out + (self.parents,)
        return out


def _draw_power(rng, n_machine_types: int) -> np.ndarray:
    """[idle_W, active_W] per machine type — one Monte-Carlo draw."""
    return np.stack([rng.uniform(20, 60, n_machine_types),
                     rng.uniform(80, 300, n_machine_types)],
                    axis=1).astype(np.float32)


def _draw_workload(spec: ExperimentSpec, eet, r: int):
    """Arrival-process draw of replica ``r``; ``arrivals=None`` is the
    direct Poisson call (equal to the registered "poisson" one)."""
    wk, sc, n_p = spec.workload, spec.scenario, len(spec.policy.policies)
    seed = spec.seed + 7919 * r
    if wk.arrivals is None:
        return poisson_workload(wk.n_tasks, rate=wk.rate,
                                n_task_types=wk.n_task_types,
                                mean_eet=eet.eet.mean(1), slack=4.0,
                                seed=seed)
    if sc is not None:
        idx = (r // (len(sc.fail_rates) * len(sc.dvfs_states) * n_p)) \
            % len(wk.arrivals)
    else:
        idx = (r // n_p) % len(wk.arrivals)
    gen = ARRIVAL_GENERATORS[wk.arrivals[idx]]
    return gen(wk.n_tasks, wk.rate, wk.n_task_types, eet.eet.mean(1), seed)


def _draw_flat_replica(spec: ExperimentSpec, r: int) -> dict:
    """One replica, fully determined by ``(spec, r)``: the draws (power,
    [spot], noise, mtype — in that order) come from
    ``default_rng([seed, r])``, the EET table, the workload and the
    failure trace from their own seeds, exactly as the reference draws
    them."""
    wk, fl, sc = spec.workload, spec.fleet, spec.scenario
    policies = spec.policy.policies
    n_p = len(policies)
    rng = np.random.default_rng([spec.seed, r])
    eet = synth_eet(wk.n_task_types, fl.n_machine_types, inconsistency=0.3,
                    seed=spec.seed + r)
    power = _draw_power(rng, fl.n_machine_types)
    wl = _draw_workload(spec, eet, r)
    out = {}
    if sc is not None:
        n_f, n_d = len(sc.fail_rates), len(sc.dvfs_states)
        scen = make_scenario(
            wl, fl.n_machines, fail_rate=sc.fail_rates[r % n_f],
            mttr=sc.mttr, spot=(rng.random() < sc.spot_frac),
            dvfs=sc.dvfs_states[(r // n_f) % n_d],
            n_intervals=sc.n_intervals, seed=spec.seed + 31 * r)
        out.update(speed=scen.speed, power_scale=scen.power_scale,
                   down_start=scen.down_start, down_end=scen.down_end,
                   kill=scen.kill)
        pol = policies[(r // (n_f * n_d)) % n_p]
    else:
        pol = policies[r % n_p]
    noise = rng.lognormal(0.0, 0.1, wk.n_tasks).astype(np.float32)
    mt = rng.integers(0, fl.n_machine_types, fl.n_machines)
    out.update(arrival=wl.arrival, type_id=wl.type_id,
               deadline=wl.deadline, eet=eet.eet, power=power, noise=noise,
               mtype=mt, policy=P.POLICY_IDS[pol])
    return out


def _draw_workflow_cell(spec: ExperimentSpec, cell: int) -> dict:
    """One workflow cell, shared by its ``n_p`` paired replicas and fully
    determined by ``(spec, cell)``: the draws (power, spot, noise, mtype,
    in that order) come from ``default_rng(seed + 104729 * cell)``, the
    EET table, the DAG and the failure trace from their own seeds, as
    the reference draws them.  Workflow cells always carry dynamics."""
    wk, fl = spec.workload, spec.fleet
    sc = spec.scenario or ScenarioAxis()
    n_s, n_f = len(wk.shapes), len(sc.fail_rates)
    crng = np.random.default_rng(spec.seed + 104729 * cell)
    eet = synth_eet(wk.n_task_types, fl.n_machine_types, inconsistency=0.3,
                    seed=spec.seed + cell)
    power = _draw_power(crng, fl.n_machine_types)
    gen = WORKFLOW_GENERATORS[wk.shapes[cell % n_s]]
    wf = gen(wk.n_tasks, wk.n_task_types, eet.eet.mean(1),
             spec.seed + 7919 * cell)
    scen = make_scenario(
        wf.workload, fl.n_machines,
        fail_rate=sc.fail_rates[(cell // n_s) % n_f],
        mttr=sc.mttr, spot=(crng.random() < sc.spot_frac),
        dvfs=sc.dvfs_states[(cell // (n_s * n_f)) % len(sc.dvfs_states)],
        n_intervals=sc.n_intervals, seed=spec.seed + 31 * cell)
    noise = crng.lognormal(0.0, 0.1, wk.n_tasks).astype(np.float32)
    mt = crng.integers(0, fl.n_machine_types, fl.n_machines)
    wl = wf.workload
    return dict(arrival=wl.arrival, type_id=wl.type_id, deadline=wl.deadline,
                eet=eet.eet, power=power, noise=noise, mtype=mt,
                rank=wf.ranks(eet.eet.mean(1)), parents=wf.parents,
                speed=scen.speed, power_scale=scen.power_scale,
                down_start=scen.down_start, down_end=scen.down_end,
                kill=scen.kill)


def _materialize_flat(spec: ExperimentSpec, lo: int = 0,
                      hi: int | None = None) -> list[dict]:
    """Flat and scenario modes: the draws of replicas ``[lo, hi)``, each
    from its own substream, so a range draws the same whether alone or
    as part of the whole grid."""
    hi = spec.n_replicas if hi is None else hi
    return [_draw_flat_replica(spec, r) for r in range(lo, hi)]


_KMAX_CACHE: dict[ExperimentSpec, int] = {}


def _workflow_kmax(spec: ExperimentSpec) -> int:
    """The grid-wide widest DAG in-degree, the parent tables' pad width:
    a generate-and-discard pass over the cells (DAG generation is
    deterministic per cell), equal to the width :func:`normalize` pads
    to, cached per spec so that every chunk of a grid pads alike."""
    km = _KMAX_CACHE.get(spec)
    if km is None:
        wk, fl = spec.workload, spec.fleet
        n_p = len(spec.policy.policies)
        km = 0
        for cell in range(-(-spec.n_replicas // n_p)):
            eet = synth_eet(wk.n_task_types, fl.n_machine_types,
                            inconsistency=0.3, seed=spec.seed + cell)
            gen = WORKFLOW_GENERATORS[wk.shapes[cell % len(wk.shapes)]]
            wf = gen(wk.n_tasks, wk.n_task_types, eet.eet.mean(1),
                     spec.seed + 7919 * cell)
            km = max(km, wf.parents.shape[1])
        _KMAX_CACHE[spec] = km
    return km


def _materialize_workflow(spec: ExperimentSpec, lo: int = 0,
                          hi: int | None = None, k_max: int | None = None
                          ) -> tuple[list[dict], np.ndarray]:
    """Workflow mode, replicas ``[lo, hi)``: one draw per cell, shared by
    its paired replicas (policy ``r % n_p``), and the (hi - lo, N, K)
    parent tables padded with -1 to ``k_max`` (default: the range's
    widest in-degree; chunks pass the grid's, :func:`_workflow_kmax`)."""
    hi = spec.n_replicas if hi is None else hi
    policies = spec.policy.policies
    n_p = len(policies)
    draws = []
    for cell in range(lo // n_p, -(-hi // n_p)):
        d = _draw_workflow_cell(spec, cell)
        for p in range(n_p):
            if lo <= cell * n_p + p < hi:
                draws.append({**d, "policy": P.POLICY_IDS[policies[p]]})
    if k_max is None:
        k_max = max(d["parents"].shape[1] for d in draws)
    parents = np.full((hi - lo, spec.workload.n_tasks, k_max), -1, np.int32)
    for i, d in enumerate(draws):
        parents[i, :, :d["parents"].shape[1]] = d["parents"]
    return draws, parents


def _stack(spec: ExperimentSpec, draws: list[dict],
           parents: np.ndarray | None, dev: torch.device) -> Replicas:
    """The per-replica draws stacked into one :class:`Replicas` on
    ``dev``."""
    def stack(key, dtype):
        return np.stack([d[key] for d in draws]).astype(dtype)

    def put(key, dtype, tdtype):
        return torch.as_tensor(stack(key, dtype), dtype=tdtype, device=dev)

    tasks = task_table(stack("arrival", np.float32),
                       stack("type_id", np.int32),
                       stack("deadline", np.float32), device=dev)
    tables = S.StaticTables(
        eet=put("eet", np.float32, torch.float32),
        power=put("power", np.float32, torch.float32),
        noise=put("noise", np.float32, torch.float32),
        rank=put("rank", np.float32, torch.float32) if spec.workflow
        else torch.zeros((len(draws), spec.workload.n_tasks),
                         dtype=torch.float32, device=dev))
    dyn = None
    if spec.scenario is not None or spec.workflow:
        dyn = S.MachineDynamics(
            speed=put("speed", np.float32, torch.float32),
            power_scale=put("power_scale", np.float32, torch.float32),
            down_start=put("down_start", np.float32, torch.float32),
            down_end=put("down_end", np.float32, torch.float32),
            kill=put("kill", bool, torch.bool))
    return Replicas(tasks, put("mtype", np.int32, torch.int32), tables,
                    torch.as_tensor([d["policy"] for d in draws],
                                    dtype=torch.int32, device=dev), dyn,
                    None if parents is None
                    else torch.as_tensor(parents, device=dev))


def normalize(spec: ExperimentSpec, device="cuda") -> Replicas:
    """Draw every replica of the spec on the host and stack the inputs
    on ``device`` (numpy draws, bit-equal to the reference's)."""
    dev = resolve_device(device)
    if spec.workflow:
        return _stack(spec, *_materialize_workflow(spec), dev)
    return _stack(spec, _materialize_flat(spec), None, dev)


def normalize_chunk(spec: ExperimentSpec, lo: int, hi: int,
                    device="cuda") -> Replicas:
    """Replicas ``[lo, hi)`` of the grid on ``device``, bitwise the slice
    of :func:`normalize`'s output without drawing the other replicas
    (per-replica and per-cell substreams make the grid random-access);
    workflow chunks pad their parent tables to the grid's widest
    in-degree."""
    if not (0 <= lo < hi <= spec.n_replicas):
        raise ValueError(f"chunk [{lo}, {hi}) outside grid "
                         f"[0, {spec.n_replicas})")
    dev = resolve_device(device)
    if spec.workflow:
        return _stack(spec, *_materialize_workflow(
            spec, lo, hi, k_max=_workflow_kmax(spec)), dev)
    return _stack(spec, _materialize_flat(spec, lo, hi), None, dev)


def to_streams(reps: Replicas, chunk: int) -> ST.TaskStream:
    """The stacked (R, N) replica columns as (R, nc, C) stream columns
    on their device (the batch form of ``streaming.make_stream``; noise
    and rank ride in the stream, the tail chunk pads with ``gid = -1``
    rows)."""
    if reps.parents is not None:
        raise ValueError("streaming replicas cannot carry parent tables")
    r, n = reps.tasks.arrival.shape
    chunk = int(chunk)
    n_chunks = max(-(-n // chunk), 1)
    total = n_chunks * chunk

    def pad(x, fill):
        out = torch.full((r, total), fill, dtype=x.dtype, device=x.device)
        out[:, :n] = x
        return out.view(r, n_chunks, chunk)

    gid = torch.arange(n, dtype=torch.int32, device=reps.mtype.device)
    return ST.TaskStream(
        arrival=pad(reps.tasks.arrival, S.INF),
        type_id=pad(reps.tasks.type_id, 0),
        deadline=pad(reps.tasks.deadline, S.INF),
        noise=pad(reps.tables.noise, 1.0),
        rank=pad(reps.tables.rank, 0.0),
        gid=pad(gid.expand(r, n), -1))


@dataclass
class ExperimentResult:
    """Output of :func:`run_experiment`: the inputs, the (R,) summary
    columns, the final state (a dense run's) or final window (a
    streaming run's, ``streaming.WindowState``) and, for a traced spec,
    its batched ``trace.TraceBuffer``.  A chunked run (``chunk=``)
    carries the exact aggregate ``launch/chunked.SweepAgg`` in ``agg``
    and its timing in ``chunked``; its ``replicas`` are None
    and its ``metrics`` None, or with ``keep_replicas=True`` the
    per-replica columns on the host."""
    spec: ExperimentSpec
    replicas: Replicas | None
    metrics: dict | None
    state: S.SimState | None = None
    traces: object = None
    window: ST.WindowState | None = None
    agg: object = None
    chunked: object = None

    def by_policy(self, keys: tuple[str, ...] = ("completion_rate",
                                                 "missed", "energy",
                                                 "makespan")) -> list[dict]:
        """Per-policy mean rows (host-side), in spec policy order; a
        chunked result reads them off its aggregate (exact means)."""
        if self.agg is not None:
            return self.agg.by_policy(keys)
        pids = self.replicas.policy_ids.cpu().numpy()
        cols = {k: self.metrics[k].cpu().numpy() for k in keys}
        rows = []
        for pol in self.spec.policy.policies:
            sel = pids == P.POLICY_IDS[pol]
            row = {"policy": pol, "replicas": int(sel.sum())}
            for k in keys:
                row[k] = float(np.mean(cols[k][sel]))
            rows.append(row)
        return rows


def _execute(spec: ExperimentSpec, reps: Replicas,
             stats: E.RunStats | None = None,
             policy_params=None) -> ExperimentResult:
    """Run the replicas ``reps`` of ``spec`` on their device and
    summarize them there: ``engine.run_sweep``, or for a streaming spec
    ``streaming.run_stream`` on :func:`to_streams` of them."""
    if spec.streaming:
        stream = to_streams(reps, spec.stream_chunk)
        ws = ST.run_stream(stream, reps.mtype, reps.tables.eet,
                           reps.tables.power, reps.policy_ids,
                           spec.stream_params, reps.dynamics, stats,
                           policy_params)
        n = (stream.gid >= 0).sum((1, 2), dtype=torch.int32)
        return ExperimentResult(
            spec, reps, ST.summarize_stream_replica(ws, n, reps.dynamics),
            traces=ws.sim.trace, window=ws)
    st = E.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                     spec.sim_params, stats, reps.dynamics, reps.parents,
                     policy_params)
    return ExperimentResult(
        spec, reps, summarize_replica(st, reps.tables, reps.dynamics), st,
        st.trace)


def run_experiment(spec: ExperimentSpec, *, device="cuda",
                   replicas: Replicas | None = None,
                   stats: E.RunStats | None = None,
                   chunk: int | None = None, keep_replicas: bool = False,
                   on_chunk=None, policy_params=None) -> ExperimentResult:
    """normalize -> run every replica -> summarize, on ``device``; a
    streaming spec runs ``streaming.run_stream`` and returns its final
    window in ``.window``.  ``replicas`` skips normalization (e.g.
    inputs made by ``interop.replicas_from_numpy``); ``stats`` receives
    the engine's loop counters; ``policy_params`` (``neural.
    PolicyParams``, shared by the replicas) are the learned policies'
    weights.

    ``chunk=C`` runs the grid C replicas at a time
    (``launch/chunked.run_chunked_experiment``): each chunk's summaries
    fold on the device into an exact ``SweepAgg`` (``.agg``), bitwise
    the same for every chunk size, with chunk c + 1 normalized on the
    host while chunk c runs, so device memory stays O(C);
    ``keep_replicas`` also gathers the per-replica columns on the host,
    and ``on_chunk(c)`` is called as chunk c retires.

    With telemetry on (``core/telemetry.py``) the run writes the spans
    ``experiment``, ``normalize`` and ``execute`` (a chunked run:
    ``chunk_normalize``, ``chunk_dispatch`` and ``chunk_sync`` a
    chunk).  The reference's ``compile`` span and ``cache`` event have
    no counterpart: the port has no executable cache yet (ROADMAP.md,
    queue A item 2)."""
    if chunk is not None:
        from repro_torch.launch.chunked import run_chunked_experiment
        return run_chunked_experiment(
            spec, chunk, device=device, replicas=replicas,
            keep_replicas=keep_replicas, on_chunk=on_chunk, stats=stats,
            policy_params=policy_params)
    if keep_replicas or on_chunk is not None:
        raise ValueError("keep_replicas/on_chunk only apply with chunk=")
    dev = resolve_device(device)
    with TL.span("experiment", streaming=spec.streaming,
                 policies=spec.policy.policies, backend=dev.type) as xsp:
        with TL.span("normalize") as nsp:
            reps = replicas if replicas is not None else normalize(spec, dev)
            nsp["n_replicas"] = reps.n_replicas
            nsp["reused"] = replicas is not None
        xsp["n_replicas"] = reps.n_replicas
        with TL.span("execute"):
            res = _execute(spec, reps, stats, policy_params)
            # only wait for the card when someone is timing the stage
            if TL.current() is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return res
