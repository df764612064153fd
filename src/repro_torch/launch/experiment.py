"""ExperimentSpec for flat replica sweeps: spec -> normalize -> run.

The counterpart of ``repro.launch.experiment`` for the flat mode (static
fleet, independent tasks, Poisson arrivals): the same axes, the same
per-replica random draws, the same summary columns.

  spec       :class:`ExperimentSpec` — ``FleetAxis x WorkloadAxis x
             PolicyAxis``, policy ``r % n_policies`` for replica r.
  normalize  :func:`normalize` — draw every replica on the host with
             numpy, from the substream ``default_rng([seed, r])`` in the
             reference's order, and hand the stacked tables to torch.
  execute    :func:`run_experiment` — normalize + ``engine.run_sweep`` +
             :func:`summarize_replica` on the device.

Scenario, workflow, streaming, tracing, metrics and learned-policy cells
are later slices of the port; their axes do not exist here yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import energy as EN
from repro_torch.core import engine as E
from repro_torch.core import schedulers as P
from repro_torch.core import state as S
from repro_torch.core.eet import synth_eet
from repro_torch.core.reduce import ordered_sum
from repro_torch.core.workload import poisson_workload, task_table

__all__ = ["FleetAxis", "WorkloadAxis", "PolicyAxis", "ExperimentSpec",
           "Replicas", "ExperimentResult", "normalize", "run_experiment",
           "summarize_replica"]


def summarize_replica(st: S.SimState, tables: S.StaticTables) -> dict:
    """(R,) summary columns of every replica, on the device."""
    status = st.tasks.status
    completed = (status == S.COMPLETED).sum(1, dtype=torch.int32)
    missed = ((status == S.MISSED_QUEUE) | (status == S.MISSED_RUNNING)
              ).sum(1, dtype=torch.int32)
    cancelled = (status == S.CANCELLED).sum(1, dtype=torch.int32)
    preempted = (status == S.PREEMPTED).sum(1, dtype=torch.int32)
    makespan = EN.makespan(st)
    active_e = ordered_sum(st.machines.energy, 1)
    idle_e = ordered_sum(EN.idle_energy(st, tables), 1)
    n = status.shape[1]
    response = torch.where(status == S.COMPLETED,
                           st.tasks.t_end - st.tasks.arrival, 0.0)
    return {
        "completed": completed, "missed": missed, "cancelled": cancelled,
        "preempted": preempted,
        "requeues": st.n_preempts.sum(1, dtype=torch.int32) - preempted,
        "availability": torch.ones_like(makespan),
        # the reference's compiler turns the division by the constant n
        # into a multiplication by its float32 reciprocal
        "completion_rate": completed * torch.tensor(
            1.0 / n, dtype=torch.float32, device=status.device),
        "makespan": makespan,
        "energy": active_e + idle_e,
        "active_energy": active_e,
        "idle_energy": idle_e,
        "mean_response": ordered_sum(response, 1)
        / torch.clamp(completed, min=1),
    }


@dataclass(frozen=True)
class FleetAxis:
    """Fleet size and machine-type diversity; each replica draws its
    machine-type assignment and power table independently."""
    n_machines: int
    n_machine_types: int = 4


@dataclass(frozen=True)
class WorkloadAxis:
    """The task side: Poisson arrivals of ``n_tasks`` tasks at ``rate``.
    ``arrivals`` names other arrival processes in the reference; only
    None (Poisson everywhere) is ported."""
    n_tasks: int
    n_task_types: int = 4
    rate: float = 4.0
    arrivals: tuple[str, ...] | None = None

    def __post_init__(self):
        if self.arrivals is not None:
            raise NotImplementedError(
                "arrival-process axes are not ported yet (ROADMAP.md, "
                "queue A item 5)")


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
    """A flat experiment: replica r runs policy ``r % n_policies`` on its
    own draw of EET table, power table, workload, noise and fleet."""
    n_replicas: int
    fleet: FleetAxis
    workload: WorkloadAxis
    policy: PolicyAxis = field(default_factory=PolicyAxis)
    sim: E.SimParams = field(default_factory=E.SimParams)
    seed: int = 0

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got "
                             f"{self.n_replicas}")


@dataclass
class Replicas:
    """Stacked per-replica inputs (leading axis R on every tensor)."""
    tasks: S.TaskTable
    mtype: torch.Tensor        # i32 (R, M)
    tables: S.StaticTables
    policy_ids: torch.Tensor   # i32 (R,)

    @property
    def n_replicas(self) -> int:
        return int(self.policy_ids.shape[0])


def _draw_power(rng, n_machine_types: int) -> np.ndarray:
    """[idle_W, active_W] per machine type — one Monte-Carlo draw."""
    return np.stack([rng.uniform(20, 60, n_machine_types),
                     rng.uniform(80, 300, n_machine_types)],
                    axis=1).astype(np.float32)


def _draw_flat_replica(spec: ExperimentSpec, r: int) -> dict:
    """One replica, fully determined by ``(spec, r)``: the draws (power,
    noise, mtype — in that order) come from ``default_rng([seed, r])``,
    the EET table and the workload from their own seeds, exactly as the
    reference draws them."""
    wk, fl = spec.workload, spec.fleet
    policies = spec.policy.policies
    rng = np.random.default_rng([spec.seed, r])
    eet = synth_eet(wk.n_task_types, fl.n_machine_types, inconsistency=0.3,
                    seed=spec.seed + r)
    power = _draw_power(rng, fl.n_machine_types)
    wl = poisson_workload(wk.n_tasks, rate=wk.rate,
                          n_task_types=wk.n_task_types,
                          mean_eet=eet.eet.mean(1), slack=4.0,
                          seed=spec.seed + 7919 * r)
    noise = rng.lognormal(0.0, 0.1, wk.n_tasks).astype(np.float32)
    mt = rng.integers(0, fl.n_machine_types, fl.n_machines)
    return {"arrival": wl.arrival, "type_id": wl.type_id,
            "deadline": wl.deadline, "eet": eet.eet, "power": power,
            "noise": noise, "mtype": mt,
            "policy": P.POLICY_IDS[policies[r % len(policies)]]}


def normalize(spec: ExperimentSpec, device="cuda") -> Replicas:
    """Draw every replica of the spec on the host and stack the inputs
    on ``device`` (numpy draws, bit-equal to the reference's)."""
    dev = resolve_device(device)
    draws = [_draw_flat_replica(spec, r) for r in range(spec.n_replicas)]

    def stack(key, dtype):
        return np.stack([d[key] for d in draws]).astype(dtype)

    def put(key, dtype, tdtype):
        return torch.as_tensor(stack(key, dtype), dtype=tdtype, device=dev)

    n = spec.workload.n_tasks
    tasks = task_table(stack("arrival", np.float32),
                       stack("type_id", np.int32),
                       stack("deadline", np.float32), device=dev)
    tables = S.StaticTables(
        eet=put("eet", np.float32, torch.float32),
        power=put("power", np.float32, torch.float32),
        noise=put("noise", np.float32, torch.float32),
        rank=torch.zeros((spec.n_replicas, n), dtype=torch.float32,
                         device=dev))
    return Replicas(tasks, put("mtype", np.int32, torch.int32), tables,
                    torch.as_tensor([d["policy"] for d in draws],
                                    dtype=torch.int32, device=dev))


@dataclass
class ExperimentResult:
    """Output of :func:`run_experiment`: the inputs, the (R,) summary
    columns, and the final state."""
    spec: ExperimentSpec
    replicas: Replicas
    metrics: dict
    state: S.SimState | None = None

    def by_policy(self, keys: tuple[str, ...] = ("completion_rate",
                                                 "missed", "energy",
                                                 "makespan")) -> list[dict]:
        """Per-policy mean rows (host-side), in spec policy order."""
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


def run_experiment(spec: ExperimentSpec, *, device="cuda",
                   replicas: Replicas | None = None,
                   stats: E.RunStats | None = None) -> ExperimentResult:
    """normalize -> run every replica -> summarize, on ``device``.
    ``replicas`` skips normalization (e.g. inputs made by
    ``interop.replicas_from_numpy``); ``stats`` receives the engine's
    loop counters."""
    dev = resolve_device(device)
    reps = replicas if replicas is not None else normalize(spec, dev)
    st = E.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                     spec.sim, stats)
    return ExperimentResult(spec, reps, summarize_replica(st, reps.tables),
                            st)
