"""Simulation outputs for one replica of a batch: the report row, the
event tables and the ASCII Gantt chart.

The counterpart of ``repro.core.report``: ``SimReport``, ``metrics``,
``heterogeneity``, ``summarize`` (with the telemetry columns of
``metrics.summary`` when the state carries metrics), ``summarize_stream``
(a streaming run's row), ``trace_table``,
``task_table``, ``ascii_gantt`` and ``format_report``; each function of
a state reads replica ``replica`` of the batch.  Host-side numpy, as in
the reference; the float sums over machines use ``reduce.ordered_sum``
so the rows equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import energy as E
from repro_torch.core import metrics as ME
from repro_torch.core import state as S
from repro_torch.core import trace as T
from repro_torch.core.reduce import ordered_sum

STATUS_NAMES = {
    S.NOT_ARRIVED: "not_arrived",
    S.IN_BATCH: "in_batch",
    S.IN_MQ: "in_machine_queue",
    S.RUNNING: "running",
    S.COMPLETED: "completed",
    S.CANCELLED: "cancelled",
    S.MISSED_QUEUE: "missed_queue",
    S.MISSED_RUNNING: "missed_running",
    S.PREEMPTED: "preempted",
}


@dataclass
class SimReport:
    n_tasks: int
    completed: int
    cancelled: int
    missed_queue: int
    missed_running: int
    makespan: float
    total_energy: float
    active_energy: float
    idle_energy: float
    mean_response: float       # completion - arrival over completed tasks
    mean_wait: float           # start - arrival over started tasks
    throughput: float          # completed / makespan
    energy_per_task: float
    machine_util: np.ndarray   # (M,) active_time / makespan
    preempted: int = 0
    requeues: int = 0
    availability: float = 1.0

    @property
    def completion_rate(self) -> float:
        return self.completed / max(self.n_tasks, 1)

    @property
    def miss_rate(self) -> float:
        return (self.missed_queue + self.missed_running) / max(self.n_tasks, 1)

    @property
    def cancel_rate(self) -> float:
        return self.cancelled / max(self.n_tasks, 1)

    def row(self) -> dict:
        return {
            "n_tasks": self.n_tasks,
            "completed": self.completed, "cancelled": self.cancelled,
            "missed": self.missed_queue + self.missed_running,
            "missed_queue": self.missed_queue,
            "missed_running": self.missed_running,
            "preempted": self.preempted,
            "requeues": self.requeues,
            "completion_rate": round(self.completion_rate, 4),
            "availability": round(self.availability, 4),
            "makespan": round(self.makespan, 4),
            "energy_J": round(self.total_energy, 2),
            "active_energy_J": round(self.active_energy, 2),
            "idle_energy_J": round(self.idle_energy, 2),
            "energy_per_task_J": round(self.energy_per_task, 3),
            "mean_response_s": round(self.mean_response, 4),
            "mean_wait_s": round(self.mean_wait, 4),
            "throughput": round(self.throughput, 4),
        }


def metrics(st: S.SimState, tables: S.StaticTables, replica: int = 0,
            dynamics: S.MachineDynamics | None = None) -> SimReport:
    """Host-side report of replica ``replica`` of a final state.  Pass
    the run's ``dynamics`` for the availability and the downtime-
    corrected idle energy."""
    rows = slice(replica, replica + 1)
    one, tab = st.take(rows), tables.take(rows)
    dyn = None if dynamics is None else dynamics.take(rows)
    status = one.tasks.status[0].cpu().numpy()
    t_end = one.tasks.t_end[0].cpu().numpy()
    t_start = one.tasks.t_start[0].cpu().numpy()
    arrival = one.tasks.arrival[0].cpu().numpy()
    n = status.shape[0]
    completed = status == S.COMPLETED
    started = t_start >= 0
    span = float(E.makespan(one)[0])
    active = float(ordered_sum(E.active_energy(one), 1)[0])
    idle = float(ordered_sum(E.idle_energy(one, tab, dyn), 1)[0])
    n_done = int(completed.sum())
    util = one.machines.active_time[0].cpu().numpy() / max(span, 1e-9)
    n_pre = int((status == S.PREEMPTED).sum())
    avail = 1.0 if dyn is None else float(E.mean_availability(
        E.availability(dyn, E.makespan(one)))[0])
    return SimReport(
        n_tasks=n,
        completed=n_done,
        cancelled=int((status == S.CANCELLED).sum()),
        missed_queue=int((status == S.MISSED_QUEUE).sum()),
        missed_running=int((status == S.MISSED_RUNNING).sum()),
        preempted=n_pre,
        requeues=int(one.n_preempts[0].sum()) - n_pre,
        availability=avail,
        makespan=span,
        total_energy=active + idle,
        active_energy=active,
        idle_energy=idle,
        mean_response=float(np.mean((t_end - arrival)[completed])
                            ) if n_done else 0.0,
        mean_wait=float(np.mean((t_start - arrival)[started])
                        ) if started.any() else 0.0,
        throughput=n_done / max(span, 1e-9),
        energy_per_task=(active + idle) / max(n_done, 1),
        machine_util=util,
    )


def heterogeneity(eet: np.ndarray, mtype: np.ndarray,
                  speed: np.ndarray | None = None) -> dict:
    """HEET-style heterogeneity score of a fleet: the coefficient of
    variation of per-machine capability times the normalized entropy of
    the machine-type mix (0 for a homogeneous fleet)."""
    eet = np.asarray(eet, np.float64)
    mtype = np.asarray(mtype, np.int64)
    cap = (1.0 / eet).mean(axis=0)[mtype]
    if speed is not None:
        cap = cap * np.asarray(speed, np.float64)
    mu = float(cap.mean())
    perf_cv = float(cap.std() / mu) if mu > 0 else 0.0
    counts = np.unique(mtype, return_counts=True)[1]
    if counts.size > 1:
        p = counts / counts.sum()
        type_entropy = float(-(p * np.log(p)).sum() / np.log(counts.size))
    else:
        type_entropy = 0.0
    return {"het_perf_cv": round(perf_cv, 6),
            "het_type_entropy": round(type_entropy, 6),
            "heterogeneity": round(perf_cv * type_entropy, 6)}


def summarize(st: S.SimState, tables: S.StaticTables, replica: int = 0,
              dynamics: S.MachineDynamics | None = None) -> dict:
    """One flat dict for replica ``replica``: the ``SimReport`` row plus
    the fleet heterogeneity score and, when the state carries metrics,
    the p50/p95/p99 tails and SLO rates of ``metrics.summary``."""
    row = metrics(st, tables, replica, dynamics).row()
    row.update(heterogeneity(tables.eet[replica].cpu().numpy(),
                             st.machines.mtype[replica].cpu().numpy(),
                             st.machines.speed[replica].cpu().numpy()))
    if st.metrics is not None:
        row.update(ME.summary(st.metrics, replica=replica))
    return row


def summarize_stream(result, replica: int = 0) -> dict:
    """One flat dict for replica ``replica`` of a finished streaming run
    (a ``streaming.StreamResult``): the keys of :func:`summarize` where
    the metric exists, computed from the running aggregates, plus
    ``retired``, ``stalled``, the ``missed_queue``/``missed_running``
    split and ``mean_wait_s``; values unrounded, as the reference's."""
    from repro_torch.core import streaming as ST
    dev = ST.summarize_stream_replica(result.ws, result.n_tasks,
                                      result.dynamics)
    dev = {k: v[replica].item() for k, v in dev.items()}
    a = result.ws.agg
    span = max(dev["makespan"], 0.0)
    row = {
        "n_tasks": result.n_tasks,
        "retired": int(a.retired[replica]),
        "stalled": int(a.retired[replica]) < result.n_tasks,
        "completed": int(dev["completed"]),
        "cancelled": int(dev["cancelled"]),
        "missed": int(dev["missed"]),
        "missed_queue": int(a.missed_queue[replica]),
        "missed_running": int(a.missed_running[replica]),
        "preempted": int(dev["preempted"]),
        "requeues": int(dev["requeues"]),
        "completion_rate": dev["completion_rate"],
        "availability": dev["availability"],
        "makespan": dev["makespan"],
        "energy_J": dev["energy"],
        "active_energy_J": dev["active_energy"],
        "idle_energy_J": dev["idle_energy"],
        "energy_per_task_J": dev["energy"] / max(dev["completed"], 1),
        "mean_response_s": dev["mean_response"],
        "mean_wait_s": float(a.sum_wait[replica])
        / max(int(a.n_started[replica]), 1),
        "throughput": dev["completed"] / max(span, 1e-9),
    }
    row.update(heterogeneity(
        np.asarray(result.eet), np.asarray(result.mtype),
        result.ws.sim.machines.speed[replica].cpu().numpy()))
    if result.sim_metrics is not None:
        row.update(ME.summary(result.sim_metrics, replica=replica))
    return row


def trace_table(trace_or_state, replica: int = 0) -> list[dict]:
    """Transition log of replica ``replica`` of a traced run: one row per
    lifecycle transition, in processing order."""
    tb, _ = T.resolve(trace_or_state, replica)
    ev = T.events(tb)
    return [{
        "time": float(t), "event": T.EVENT_NAMES[int(k)],
        "task": int(task), "machine": int(m),
    } for t, k, task, m in zip(ev["time"], ev["kind"], ev["task"],
                               ev["machine"])]


def _task_columns(st: S.SimState, replica: int) -> dict:
    t = st.tasks
    return {k: getattr(t, k)[replica].cpu().numpy() for k in
            ("type_id", "arrival", "deadline", "status", "machine",
             "t_start", "t_end")}


def task_table(st: S.SimState, replica: int = 0) -> list[dict]:
    """Per-task event log of replica ``replica`` (the GUI's task panels,
    as rows)."""
    c = _task_columns(st, replica)
    return [{
        "task": i,
        "type": int(c["type_id"][i]),
        "arrival": float(c["arrival"][i]),
        "deadline": float(c["deadline"][i]),
        "status": STATUS_NAMES[int(c["status"][i])],
        "machine": int(c["machine"][i]),
        "t_start": float(c["t_start"][i]),
        "t_end": float(c["t_end"][i]),
    } for i in range(c["arrival"].shape[0])]


def ascii_gantt(st: S.SimState, width: int = 72, replica: int = 0) -> str:
    """ASCII Gantt chart of replica ``replica``'s machine occupancy."""
    span = float(E.makespan(st.take(slice(replica, replica + 1)))[0])
    if span <= 0:
        return "(empty schedule)"
    n_m = int(st.machines.mtype.shape[1])
    c = _task_columns(st, replica)
    status, machine = c["status"], c["machine"]
    t0, t1 = c["t_start"], c["t_end"]
    lines = [f"gantt 0..{span:.2f}s  ('#'=completed, 'x'=dropped while "
             f"running)"]
    for m in range(n_m):
        row = [" "] * width
        for i in np.nonzero((machine == m) & (t0 >= 0))[0]:
            a = int(t0[i] / span * (width - 1))
            b = max(int(t1[i] / span * (width - 1)), a)
            ch = "#" if status[i] == S.COMPLETED else "x"
            for col in range(a, b + 1):
                row[col] = ch
        lines.append(f"m{m:02d} |{''.join(row)}|")
    return "\n".join(lines)


def format_report(rep: SimReport) -> str:
    r = rep.row()
    head = " | ".join(f"{k}={v}" for k, v in r.items())
    util = " ".join(f"{u:.2f}" for u in rep.machine_util)
    return f"{head}\n     machine_util: [{util}]"
