"""Workload generation: numpy arrival draws, handed to torch at the end.

A copy of the parts of ``repro.core.workload`` the port runs: the five
arrival generators and their registry, the chunked views that the
streaming engine consumes (``iter_workload_chunks``,
``poisson_workload_chunks``), the task-table conversion, the
workflow (DAG) shapes (``Workflow``, ``upward_ranks``, the four
generators and their registry), and the dynamic-fleet inputs
(``DVFS_STATES``, ``failure_trace``, ``Scenario``, ``make_scenario``)
and the E2C trace files (``load_workload_csv``, ``save_workload_csv``).
For the same seed, or the same file, every array is bit-equal to the
reference's; only ``Scenario.dynamics`` differs, in returning the port's
``state.MachineDynamics``.
"""
from __future__ import annotations

import csv
import io
import os
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.state import MachineDynamics, TaskTable


@dataclass
class Workload:
    arrival: np.ndarray    # (N,) f32, sorted ascending
    type_id: np.ndarray    # (N,) i32
    deadline: np.ndarray   # (N,) f32 absolute

    def __post_init__(self):
        self.arrival = np.asarray(self.arrival, np.float32)
        self.type_id = np.asarray(self.type_id, np.int32)
        self.deadline = np.asarray(self.deadline, np.float32)
        order = np.argsort(self.arrival, kind="stable")
        self.arrival = self.arrival[order]
        self.type_id = self.type_id[order]
        self.deadline = self.deadline[order]

    @property
    def n_tasks(self) -> int:
        return self.arrival.shape[0]

    def to_task_table(self, device="cuda") -> TaskTable:
        """A one-replica (1, N) task table on ``device``."""
        return task_table(self.arrival[None], self.type_id[None],
                          self.deadline[None], device=device)


def task_table(arrival: np.ndarray, type_id: np.ndarray,
               deadline: np.ndarray, device="cuda") -> TaskTable:
    """(R, N) task table from stacked numpy columns; the lifecycle
    columns are placeholders that ``state.init_state`` resets."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    r, n = np.shape(arrival)
    zeros_i = torch.zeros((r, n), dtype=torch.int32, device=dev)
    zeros_f = torch.zeros((r, n), dtype=torch.float32, device=dev)
    return TaskTable(
        arrival=put(arrival, torch.float32),
        type_id=put(type_id, torch.int32),
        deadline=put(deadline, torch.float32),
        status=zeros_i,
        machine=torch.full((r, n), -1, dtype=torch.int32, device=dev),
        seq=zeros_i.clone(),
        t_start=zeros_f,
        t_end=zeros_f.clone(),
    )


def poisson_workload(n_tasks: int, rate: float, n_task_types: int, *,
                     mean_eet: np.ndarray | None = None,
                     slack: float = 3.0, slack_jitter: float = 0.5,
                     type_probs: np.ndarray | None = None,
                     seed: int = 0) -> Workload:
    """Poisson arrivals at ``rate`` tasks/sec; deadline = arrival +
    slack * lognormal jitter * mean EET of the task's type."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_tasks)
    arrival = np.cumsum(gaps).astype(np.float32)
    if type_probs is None:
        type_probs = np.full(n_task_types, 1.0 / n_task_types)
    type_id = rng.choice(n_task_types, size=n_tasks, p=type_probs)
    if mean_eet is None:
        mean_eet = np.ones(n_task_types, np.float32)
    jitter = rng.lognormal(0.0, slack_jitter, size=n_tasks)
    deadline = arrival + slack * jitter * mean_eet[type_id]
    return Workload(arrival, type_id, deadline.astype(np.float32))


def uniform_workload(n_tasks: int, horizon: float, n_task_types: int, *,
                     mean_eet: np.ndarray | None = None, slack: float = 3.0,
                     seed: int = 0) -> Workload:
    rng = np.random.default_rng(seed)
    arrival = np.sort(rng.uniform(0, horizon, n_tasks)).astype(np.float32)
    type_id = rng.integers(0, n_task_types, n_tasks)
    if mean_eet is None:
        mean_eet = np.ones(n_task_types, np.float32)
    deadline = arrival + slack * mean_eet[type_id]
    return Workload(arrival, type_id, deadline.astype(np.float32))


def bursty_workload(n_tasks: int, rate: float, n_task_types: int, *,
                    burst_factor: float = 8.0, burst_prob: float = 0.1,
                    mean_eet: np.ndarray | None = None, slack: float = 3.0,
                    seed: int = 0) -> Workload:
    """Markov-modulated Poisson: occasional bursts at burst_factor*rate."""
    rng = np.random.default_rng(seed)
    bursting = rng.random(n_tasks) < burst_prob
    rates = np.where(bursting, rate * burst_factor, rate)
    gaps = rng.exponential(1.0 / rates)
    arrival = np.cumsum(gaps).astype(np.float32)
    type_id = rng.integers(0, n_task_types, n_tasks)
    if mean_eet is None:
        mean_eet = np.ones(n_task_types, np.float32)
    deadline = arrival + slack * mean_eet[type_id]
    return Workload(arrival, type_id, deadline.astype(np.float32))


def diurnal_workload(n_tasks: int, base_rate: float, n_task_types: int, *,
                     amplitude: float = 0.8, period: float = 120.0,
                     mean_eet: np.ndarray | None = None, slack: float = 3.0,
                     slack_jitter: float = 0.5, seed: int = 0) -> Workload:
    """Non-homogeneous Poisson with rate ``base_rate * (1 + amplitude *
    sin(2 pi t / period))``, sampled by thinning a ``base_rate * (1 +
    amplitude)`` process; ``amplitude`` in [0, 1]."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    rng = np.random.default_rng(seed)
    rate_max = base_rate * (1.0 + amplitude)
    arrival = np.empty(n_tasks, np.float64)
    t, k = 0.0, 0
    while k < n_tasks:
        t += rng.exponential(1.0 / rate_max)
        rate_t = base_rate * (1.0 + amplitude * np.sin(2 * np.pi * t / period))
        if rng.random() * rate_max <= rate_t:
            arrival[k] = t
            k += 1
    arrival = arrival.astype(np.float32)
    type_id = rng.integers(0, n_task_types, n_tasks)
    if mean_eet is None:
        mean_eet = np.ones(n_task_types, np.float32)
    jitter = rng.lognormal(0.0, slack_jitter, size=n_tasks)
    deadline = arrival + slack * jitter * mean_eet[type_id]
    return Workload(arrival, type_id, deadline.astype(np.float32))


def onoff_workload(n_tasks: int, rate: float, n_task_types: int, *,
                   mean_on: float = 20.0, mean_off: float = 10.0,
                   off_rate_frac: float = 0.05,
                   mean_eet: np.ndarray | None = None, slack: float = 3.0,
                   slack_jitter: float = 0.5, seed: int = 0) -> Workload:
    """Two-state Markov-modulated Poisson: exponential ON/OFF dwell
    times, emitting at ``rate`` when ON and ``off_rate_frac * rate``
    when OFF."""
    rng = np.random.default_rng(seed)
    arrival = np.empty(n_tasks, np.float64)
    t, k = 0.0, 0
    on = True
    t_switch = rng.exponential(mean_on)
    while k < n_tasks:
        r = rate if on else max(rate * off_rate_frac, 1e-9)
        gap = rng.exponential(1.0 / r)
        if t + gap >= t_switch:
            # memoryless: restart the draw from the switch point
            t = t_switch
            on = not on
            t_switch = t + rng.exponential(mean_on if on else mean_off)
            continue
        t += gap
        arrival[k] = t
        k += 1
    arrival = arrival.astype(np.float32)
    type_id = rng.integers(0, n_task_types, n_tasks)
    if mean_eet is None:
        mean_eet = np.ones(n_task_types, np.float32)
    jitter = rng.lognormal(0.0, slack_jitter, size=n_tasks)
    deadline = arrival + slack * jitter * mean_eet[type_id]
    return Workload(arrival, type_id, deadline.astype(np.float32))


# Named arrival processes with one call shape, so an experiment can sweep
# the arrival pattern: f(n_tasks, rate, n_task_types, mean_eet, seed)
ARRIVAL_GENERATORS = {
    "poisson": lambda n, rate, ntt, me, seed: poisson_workload(
        n, rate=rate, n_task_types=ntt, mean_eet=me, slack=4.0, seed=seed),
    "bursty": lambda n, rate, ntt, me, seed: bursty_workload(
        n, rate=rate, n_task_types=ntt, mean_eet=me, slack=4.0, seed=seed),
    "diurnal": lambda n, rate, ntt, me, seed: diurnal_workload(
        n, base_rate=rate, n_task_types=ntt, mean_eet=me, slack=4.0,
        seed=seed),
    "onoff": lambda n, rate, ntt, me, seed: onoff_workload(
        n, rate=rate, n_task_types=ntt, mean_eet=me, slack=4.0, seed=seed),
}


def register_arrival_generator(name: str, fn) -> None:
    """Register ``fn(n_tasks, rate, n_task_types, mean_eet, seed) ->
    Workload`` under ``name`` for ``WorkloadAxis(arrivals=...)``;
    duplicates raise."""
    if name in ARRIVAL_GENERATORS:
        raise ValueError(f"arrival generator {name!r} already registered")
    ARRIVAL_GENERATORS[name] = fn


def resolve_arrivals(names) -> tuple[str, ...]:
    """Validate arrival-generator names against the registry."""
    names = tuple(names)
    unknown = [n for n in names if n not in ARRIVAL_GENERATORS]
    if unknown:
        raise ValueError(f"unknown arrival generators {unknown}; known: "
                         f"{sorted(ARRIVAL_GENERATORS)}")
    return names


def iter_workload_chunks(w: Workload, chunk: int):
    """Yield ``w`` as consecutive ``Workload`` slices of ``chunk`` tasks
    (the tail may be short), in arrival order: the host-side view of the
    arrival stream that ``streaming.make_stream`` packs into columns."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for i in range(0, w.n_tasks, chunk):
        yield Workload(w.arrival[i:i + chunk], w.type_id[i:i + chunk],
                       w.deadline[i:i + chunk])


def poisson_workload_chunks(n_tasks: int, chunk: int, rate: float,
                            n_task_types: int, *,
                            mean_eet: np.ndarray | None = None,
                            slack: float = 3.0, slack_jitter: float = 0.5,
                            type_probs: np.ndarray | None = None,
                            seed: int = 0):
    """A Poisson workload generated chunk by chunk in O(chunk) memory.
    Chunk ``i`` draws from ``default_rng([seed, i])`` with arrivals
    continuing from the previous chunk's last one, so any prefix is
    reproducible on its own; statistically :func:`poisson_workload`, but
    not bitwise (another draw order)."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if type_probs is None:
        type_probs = np.full(n_task_types, 1.0 / n_task_types)
    if mean_eet is None:
        mean_eet = np.ones(n_task_types, np.float32)
    t0 = 0.0
    for ci, lo in enumerate(range(0, n_tasks, chunk)):
        m = min(chunk, n_tasks - lo)
        rng = np.random.default_rng([seed, ci])
        gaps = rng.exponential(1.0 / rate, size=m)
        arrival = (t0 + np.cumsum(gaps)).astype(np.float32)
        t0 = float(arrival[-1])
        type_id = rng.choice(n_task_types, size=m, p=type_probs)
        jitter = rng.lognormal(0.0, slack_jitter, size=m)
        deadline = arrival + slack * jitter * np.asarray(mean_eet)[type_id]
        yield Workload(arrival, type_id, deadline.astype(np.float32))


# ---------------------------------------------------------------------------
# Workflows: precedence-constrained (DAG) workloads
# ---------------------------------------------------------------------------
@dataclass
class Workflow:
    """A workload whose tasks wait for their parents: ``parents[i, k]``
    lists the tasks that must complete before task ``i`` enters the
    system, padded with -1.  Task ids are a topological order
    (``parents[i, k] < i``), and since ``Workload`` sorts by arrival the
    arrivals must be nondecreasing in task id."""

    workload: Workload
    parents: np.ndarray     # (N, K) i32, -1 padded, parents[i, k] < i

    def __post_init__(self):
        self.parents = np.asarray(self.parents, np.int32)
        if self.parents.ndim != 2 or \
                self.parents.shape[0] != self.workload.n_tasks:
            raise ValueError(
                f"parents must be (n_tasks, K), got {self.parents.shape}")
        ids = np.arange(self.workload.n_tasks)[:, None]
        if np.any(self.parents >= ids) or np.any(self.parents < -1):
            raise ValueError("parents must satisfy -1 <= parents[i, k] < i "
                             "(task ids are a topological order)")
        if np.any(np.diff(self.workload.arrival) < 0):
            raise ValueError("workflow arrivals must be nondecreasing in "
                             "task id (ids index the sorted workload)")

    @property
    def n_tasks(self) -> int:
        return self.workload.n_tasks

    @property
    def n_edges(self) -> int:
        return int((self.parents >= 0).sum())

    def ranks(self, mean_eet: np.ndarray | None = None) -> np.ndarray:
        """(N,) HEFT upward ranks; ``mean_eet`` is the per-type mean
        execution time across machine types (``eet.eet.mean(axis=1)``)."""
        if mean_eet is None:
            w = np.ones(self.n_tasks, np.float64)
        else:
            w = np.asarray(mean_eet, np.float64)[self.workload.type_id]
        return upward_ranks(self.parents, w)


def upward_ranks(parents: np.ndarray, w: np.ndarray) -> np.ndarray:
    """HEFT upward rank ``rank(i) = w[i] + max over children rank(c)``:
    one reverse sweep over the topological id order, in float64, cast to
    float32 at the end."""
    parents = np.asarray(parents)
    rank = np.asarray(w, np.float64).copy()
    w = np.asarray(w, np.float64)
    for j in range(parents.shape[0] - 1, -1, -1):
        for p in parents[j]:
            if p >= 0:
                rank[p] = max(rank[p], w[p] + rank[j])
    return rank.astype(np.float32)


def _assemble_workflow(parent_lists: list[list[int]], n_task_types: int,
                       mean_eet: np.ndarray | None, t0: float,
                       slack: float, slack_jitter: float,
                       rng: np.random.Generator) -> Workflow:
    """Common generator tail: types, deadlines scaled by each task's
    expected critical-path length from the sources, padded table."""
    n = len(parent_lists)
    type_id = rng.integers(0, n_task_types, n)
    me = np.ones(n_task_types, np.float32) if mean_eet is None \
        else np.asarray(mean_eet, np.float32)
    w = me[type_id].astype(np.float64)
    cum = w.copy()
    for i, ps in enumerate(parent_lists):
        if ps:
            cum[i] = w[i] + max(cum[p] for p in ps)
    jitter = rng.lognormal(0.0, slack_jitter, n) if slack_jitter > 0 \
        else np.ones(n)
    deadline = (t0 + slack * jitter * cum).astype(np.float32)
    k = max((len(ps) for ps in parent_lists), default=0) or 1
    parents = np.full((n, k), -1, np.int32)
    for i, ps in enumerate(parent_lists):
        parents[i, :len(ps)] = sorted(ps)
    wl = Workload(np.full(n, t0, np.float32), type_id, deadline)
    return Workflow(wl, parents)


def chain_workflow(n_tasks: int, n_task_types: int = 1, *,
                   mean_eet: np.ndarray | None = None, t0: float = 0.0,
                   slack: float = 4.0, slack_jitter: float = 0.0,
                   seed: int = 0) -> Workflow:
    """A single chain ``0 -> 1 -> ... -> n-1``."""
    rng = np.random.default_rng(seed)
    parent_lists = [[] if i == 0 else [i - 1] for i in range(n_tasks)]
    return _assemble_workflow(parent_lists, n_task_types, mean_eet, t0,
                              slack, slack_jitter, rng)


def fork_join_workflow(n_branches: int, branch_len: int = 1,
                       n_task_types: int = 1, *,
                       mean_eet: np.ndarray | None = None, t0: float = 0.0,
                       slack: float = 4.0, slack_jitter: float = 0.0,
                       seed: int = 0) -> Workflow:
    """Source -> ``n_branches`` parallel chains of ``branch_len`` ->
    join (N = n_branches * branch_len + 2)."""
    rng = np.random.default_rng(seed)
    parent_lists: list[list[int]] = [[]]                       # source = 0
    for b in range(n_branches):
        for j in range(branch_len):
            first = b * branch_len + 1
            parent_lists.append([0] if j == 0 else [first + j - 1])
    parent_lists.append([1 + b * branch_len + branch_len - 1
                         for b in range(n_branches)])          # join
    return _assemble_workflow(parent_lists, n_task_types, mean_eet, t0,
                              slack, slack_jitter, rng)


def map_reduce_workflow(n_maps: int, n_reduces: int = 1,
                        n_task_types: int = 1, *,
                        mean_eet: np.ndarray | None = None, t0: float = 0.0,
                        slack: float = 4.0, slack_jitter: float = 0.0,
                        seed: int = 0) -> Workflow:
    """``n_maps`` independent maps, then ``n_reduces`` reduces that each
    depend on every map."""
    rng = np.random.default_rng(seed)
    maps = list(range(n_maps))
    parent_lists = [[] for _ in maps] + [list(maps)
                                         for _ in range(n_reduces)]
    return _assemble_workflow(parent_lists, n_task_types, mean_eet, t0,
                              slack, slack_jitter, rng)


def layered_workflow(n_tasks: int, n_task_types: int = 1, *,
                     n_layers: int = 4, max_parents: int = 3,
                     mean_eet: np.ndarray | None = None, t0: float = 0.0,
                     slack: float = 4.0, slack_jitter: float = 0.0,
                     seed: int = 0) -> Workflow:
    """Seeded random layered DAG: ``n_layers`` contiguous layers, each
    task after the first layer with 1 to ``max_parents`` distinct
    parents drawn from the previous layer."""
    if n_layers < 1:
        raise ValueError("n_layers must be >= 1")
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n_tasks, n_layers + 1).astype(int)
    parent_lists: list[list[int]] = []
    for layer in range(n_layers):
        lo, hi = bounds[layer], bounds[layer + 1]
        prev = list(range(bounds[layer - 1], lo)) if layer else []
        for _ in range(lo, hi):
            if not prev:
                parent_lists.append([])
            else:
                k = int(rng.integers(1, min(max_parents, len(prev)) + 1))
                parent_lists.append(sorted(
                    rng.choice(len(prev), size=k, replace=False)))
                parent_lists[-1] = [prev[j] for j in parent_lists[-1]]
    return _assemble_workflow(parent_lists, n_task_types, mean_eet, t0,
                              slack, slack_jitter, rng)


# Named DAG shapes with one call shape, so an experiment can sweep the
# shape: f(n_tasks, n_task_types, mean_eet, seed) -> Workflow
WORKFLOW_GENERATORS = {
    "chain": lambda n, ntt, me, seed: chain_workflow(
        n, ntt, mean_eet=me, seed=seed),
    "fork_join": lambda n, ntt, me, seed: fork_join_workflow(
        max(n - 2, 1), 1, ntt, mean_eet=me, seed=seed),
    "map_reduce": lambda n, ntt, me, seed: map_reduce_workflow(
        max(n - max(n // 4, 1), 1), max(n // 4, 1), ntt, mean_eet=me,
        seed=seed),
    "layered": lambda n, ntt, me, seed: layered_workflow(
        n, ntt, n_layers=4, mean_eet=me, seed=seed),
}


def register_workflow_generator(name: str, fn) -> None:
    """Register ``fn(n_tasks, n_task_types, mean_eet, seed) ->
    Workflow`` under ``name`` for ``WorkloadAxis(shapes=...)``;
    duplicates raise."""
    if name in WORKFLOW_GENERATORS:
        raise ValueError(f"workflow generator {name!r} already registered")
    WORKFLOW_GENERATORS[name] = fn


def resolve_shapes(names) -> tuple[str, ...]:
    """Validate DAG-shape names against the registry."""
    names = tuple(names)
    unknown = [n for n in names if n not in WORKFLOW_GENERATORS]
    if unknown:
        raise ValueError(f"unknown workflow generators {unknown}; known: "
                         f"{sorted(WORKFLOW_GENERATORS)}")
    return names


# ---------------------------------------------------------------------------
# Machine dynamics: availability traces + DVFS states
# ---------------------------------------------------------------------------
# DVFS operating points: (speed multiplier, power multiplier)
DVFS_STATES: dict[str, tuple[float, float]] = {
    "nominal": (1.00, 1.00),
    "balanced": (0.80, 0.55),
    "powersave": (0.60, 0.30),
    "turbo": (1.20, 1.60),
}


def failure_trace(n_machines: int, n_intervals: int, *,
                  mtbf: float, mttr: float, t0: float = 0.0,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Alternating up/down renewal process per machine: up ~ Exp(mtbf),
    down ~ Exp(mttr).  Returns ``(down_start, down_end)``, each (M, K)
    float32."""
    rng = np.random.default_rng(seed)
    down_start = np.full((n_machines, n_intervals), np.inf, np.float32)
    down_end = np.full((n_machines, n_intervals), np.inf, np.float32)
    for m in range(n_machines):
        t = t0
        for k in range(n_intervals):
            t += rng.exponential(mtbf)
            d = rng.exponential(mttr)
            down_start[m, k] = t
            down_end[m, k] = t + d
            t += d
    return down_start, down_end


@dataclass
class Scenario:
    """One simulation cell: workload + machine dynamics (per-machine
    DVFS multipliers, an (M, K) availability trace, and the eviction
    semantics: True kills, False requeues)."""

    workload: Workload
    speed: np.ndarray           # (M,)
    power_scale: np.ndarray     # (M,)
    down_start: np.ndarray      # (M, K)
    down_end: np.ndarray        # (M, K)
    kill: np.ndarray            # (M,) bool
    name: str = ""

    def __post_init__(self):
        self.speed = np.asarray(self.speed, np.float32)
        self.power_scale = np.asarray(self.power_scale, np.float32)
        self.down_start = np.asarray(self.down_start, np.float32)
        self.down_end = np.asarray(self.down_end, np.float32)
        self.kill = np.asarray(self.kill, bool)

    @property
    def n_machines(self) -> int:
        return self.speed.shape[0]

    def dynamics(self, device="cuda") -> MachineDynamics:
        """A one-replica (leading axis 1) ``MachineDynamics`` on
        ``device``."""
        dev = resolve_device(device)

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x)[None],
                                   device=dev)

        return MachineDynamics(
            speed=put(self.speed), power_scale=put(self.power_scale),
            down_start=put(self.down_start), down_end=put(self.down_end),
            kill=put(self.kill))


def make_scenario(workload: Workload, n_machines: int, *,
                  fail_rate: float = 0.0, mttr: float = 5.0,
                  spot: bool = False, dvfs: str | tuple[float, float]
                  = "nominal", n_intervals: int = 4,
                  seed: int = 0, name: str = "") -> Scenario:
    """``fail_rate`` failures per second per machine (0 = always up,
    mtbf = 1 / fail_rate); ``spot`` selects kill semantics; ``dvfs``
    names a ``DVFS_STATES`` entry or gives a (speed, power) pair, applied
    fleet-wide."""
    if isinstance(dvfs, str):
        speed_mult, power_mult = DVFS_STATES[dvfs]
    else:
        speed_mult, power_mult = dvfs
    if fail_rate > 0.0:
        down_start, down_end = failure_trace(
            n_machines, n_intervals, mtbf=1.0 / fail_rate, mttr=mttr,
            seed=seed)
    else:
        down_start = np.full((n_machines, n_intervals), np.inf, np.float32)
        down_end = np.full((n_machines, n_intervals), np.inf, np.float32)
    return Scenario(
        workload=workload,
        speed=np.full(n_machines, speed_mult, np.float32),
        power_scale=np.full(n_machines, power_mult, np.float32),
        down_start=down_start,
        down_end=down_end,
        kill=np.full(n_machines, spot, bool),
        name=name or (f"fail={fail_rate:g}" + ("/spot" if spot else "")
                      + f"/dvfs={dvfs}"),
    )


def load_workload_csv(path_or_text: str, *, n_task_types: int | None = None,
                      mean_eet: np.ndarray | None = None,
                      slack: float = 3.0) -> Workload:
    """Load an E2C trace: ``task_id,task_type,arrival_time[,deadline]``
    (a path, or the text itself).

    task_type may be an integer id or a name (names are enumerated in
    order of first appearance).  A missing deadline is synthesized as
    ``arrival + slack * mean_eet[type]`` (ones without ``mean_eet``)."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    rows = [r for r in csv.reader(io.StringIO(text)) if r and any(
        c.strip() for c in r)]
    start = 1 if not _is_float(rows[0][2]) else 0   # optional header
    names: dict[str, int] = {}
    type_id, arrival, deadline = [], [], []
    for r in rows[start:]:
        t = r[1].strip()
        if t.lstrip("-").isdigit():
            tid = int(t)
        else:
            tid = names.setdefault(t, len(names))
        type_id.append(tid)
        arrival.append(float(r[2]))
        deadline.append(float(r[3]) if len(r) > 3 and r[3].strip()
                        else np.nan)
    arrival = np.asarray(arrival, np.float32)
    type_id = np.asarray(type_id, np.int32)
    deadline = np.asarray(deadline, np.float32)
    if np.any(np.isnan(deadline)):
        nt = n_task_types or (int(type_id.max()) + 1)
        me = mean_eet if mean_eet is not None else np.ones(nt, np.float32)
        synth = arrival + slack * me[type_id]
        deadline = np.where(np.isnan(deadline), synth, deadline)
    return Workload(arrival, type_id, deadline)


def save_workload_csv(w: Workload, path: str) -> None:
    """Write ``w`` as an E2C trace with a header and six decimals."""
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["task_id", "task_type", "arrival_time", "deadline"])
        for i in range(w.n_tasks):
            wr.writerow([i, int(w.type_id[i]), f"{w.arrival[i]:.6f}",
                         f"{w.deadline[i]:.6f}"])


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
