"""Tensor-encoded simulation state, batched over replicas.

The counterpart of ``repro.core.state``: the same task lifecycle and the
same status codes, encoded as fixed-shape tensors.  Every field carries a
leading replica axis R (the reference vmaps one replica at a time):

* the *batch queue* of replica r is the set of tasks with
  ``status[r] == IN_BATCH`` (FIFO order is task-id order),
* a *machine queue* is the set of tasks with ``status[r] == IN_MQ`` and
  ``machine[r] == m`` (service order is the mapping sequence ``seq``),
* cancelled / missed tasks sit in terminal statuses.

A dynamic fleet is described by :class:`MachineDynamics` (down
intervals, eviction semantics and DVFS multipliers per machine, again
with a leading R axis); without one, ``speed`` and ``power_scale`` are
ones and no machine ever goes down.

A workflow (DAG) run adds an (R, N, K) parent table, padded with -1:
``SimState.deps_left`` counts each task's parents that are not yet
terminal, and :func:`dep_state` recomputes it, with the "some parent
failed" flag, from the status column.

With ``SimParams(trace=True)`` or ``metrics=True`` the state also
carries a ``trace.TraceBuffer`` or ``metrics.SimMetrics`` (None
otherwise); ``take`` slices them with the rest.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.reduce import ordered_sum

NOT_ARRIVED = 0      # generated but not yet in the system
IN_BATCH = 1         # waiting in the batch queue
IN_MQ = 2            # mapped: waiting in a machine's local queue
RUNNING = 3          # executing on a machine
COMPLETED = 4        # finished before its deadline
CANCELLED = 5        # scheduler cancelled
MISSED_QUEUE = 6     # deadline expired while waiting
MISSED_RUNNING = 7   # deadline expired while executing
PREEMPTED = 8        # killed by a machine failure (dynamic fleets only)

NUM_STATUSES = 9
TERMINAL = (COMPLETED, CANCELLED, MISSED_QUEUE, MISSED_RUNNING, PREEMPTED)

INT_MAX = 2**31 - 1
INF = float("inf")


def _map(obj, fn):
    """Apply ``fn`` to every tensor field of a state dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = _map(v, fn)
        out[f.name] = v
    return type(obj)(**out)


class _Batched:
    """Replica-axis helpers shared by the state dataclasses."""

    def take(self, rows):
        """The replicas selected by ``rows`` (an index or a slice)."""
        return _map(self, lambda x: x[rows])


@dataclasses.dataclass
class TaskTable(_Batched):
    """One row per task: (R, N) tensors."""

    arrival: torch.Tensor    # f32
    type_id: torch.Tensor    # i32  row of the EET matrix
    deadline: torch.Tensor   # f32  absolute time
    status: torch.Tensor     # i32
    machine: torch.Tensor    # i32  assigned machine, -1 if unmapped
    seq: torch.Tensor        # i32  mapping sequence number (queue order)
    t_start: torch.Tensor    # f32  execution start (-1 if never ran)
    t_end: torch.Tensor      # f32  terminal time (-1 while live)


@dataclasses.dataclass
class MachineState(_Batched):
    """One row per machine: (R, M) tensors."""

    mtype: torch.Tensor        # i32  row of the power table / EET column
    running: torch.Tensor      # i32  task executing, -1 idle
    busy_until: torch.Tensor   # f32  completion time of `running`
    active_time: torch.Tensor  # f32  accumulated execution seconds
    energy: torch.Tensor       # f32  accumulated active energy (J)
    speed: torch.Tensor        # f32  DVFS speed multiplier (EET /= speed)
    power_scale: torch.Tensor  # f32  DVFS power multiplier


@dataclasses.dataclass
class SimState(_Batched):
    """Full simulator state of R replicas."""

    time: torch.Tensor         # f32 (R,)
    tasks: TaskTable
    machines: MachineState
    seq_counter: torch.Tensor  # i32 (R,)   next mapping sequence number
    rr_ptr: torch.Tensor       # i32 (R,)   round-robin machine pointer
    n_events: torch.Tensor     # i32 (R,)   processed event count
    n_preempts: torch.Tensor   # i32 (R, N) forced evictions per task
    mq_count: torch.Tensor     # i32 (R, M) tasks waiting per machine queue
    n_batch: torch.Tensor      # i32 (R,)   batch-queue population
    n_live: torch.Tensor       # i32 (R,)   non-terminal population
    deps_left: torch.Tensor | None = None   # i32 (R, N) parents not yet
    #                            terminal (workflow runs; None otherwise)
    trace: object = None       # trace.TraceBuffer (SimParams(trace=True))
    metrics: object = None     # metrics.SimMetrics (SimParams(metrics=True))


@dataclasses.dataclass
class StaticTables(_Batched):
    """Read-only problem description, one per replica."""

    eet: torch.Tensor    # f32 (R, T_types, M_types) expected exec times
    power: torch.Tensor  # f32 (R, M_types, 2) [idle_W, active_W]
    noise: torch.Tensor  # f32 (R, N) actual / expected exec time
    rank: torch.Tensor   # f32 (R, N) HEFT upward rank (zeros here)


@dataclasses.dataclass
class MachineDynamics(_Batched):
    """Dynamic-scenario description of each replica's fleet.

    Machine ``m`` of replica ``r`` is down at ``t`` when
    ``down_start[r, m, k] <= t < down_end[r, m, k]`` for some k (unused
    intervals are inf).  A down transition preempts the running task and
    flushes the machine queue: with ``kill`` the evicted tasks end
    ``PREEMPTED`` (spot reclaim), otherwise they rejoin the batch queue
    and restart from scratch (fail/repair).  ``speed`` divides the EET
    rows and ``power_scale`` multiplies idle and active power.
    """

    speed: torch.Tensor        # f32 (R, M)
    power_scale: torch.Tensor  # f32 (R, M)
    down_start: torch.Tensor   # f32 (R, M, K)
    down_end: torch.Tensor     # f32 (R, M, K)
    kill: torch.Tensor         # bool (R, M)


def static_dynamics(n_machines: int, n_intervals: int = 1, *,
                    n_replicas: int = 1, device="cuda") -> MachineDynamics:
    """A no-op scenario: full speed, nominal power, never down."""
    device = resolve_device(device)
    rm = (n_replicas, n_machines)
    inf = torch.full(rm + (n_intervals,), INF, device=device)
    return MachineDynamics(
        speed=torch.ones(rm, device=device),
        power_scale=torch.ones(rm, device=device),
        down_start=inf, down_end=inf.clone(),
        kill=torch.zeros(rm, dtype=torch.bool, device=device))


def machine_up(dyn: MachineDynamics, t: torch.Tensor) -> torch.Tensor:
    """(R, M) bool: machine available (inside no down interval) at the
    replica's time ``t`` (R,)."""
    t = t[:, None, None]
    return ~((dyn.down_start <= t) & (t < dyn.down_end)).any(-1)


def dep_index(parents: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather index (R, N*K) of an (R, N, K) parent table, padding
    clamped to task 0, and its (R, N, K) validity mask; computed once a
    run, since the table never changes."""
    r, n, k = parents.shape
    idx = parents.clamp(0, max(n - 1, 0)).reshape(r, n * k).long()
    return idx, parents >= 0


def dep_state(status: torch.Tensor, parents: torch.Tensor,
              index: tuple | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-task dependency summary from the status column (R, N).

    ``parents`` is the (R, N, K) parent table, padded with -1; ``index``
    optionally its precomputed :func:`dep_index`.  Returns ``(left,
    failed)``: ``left`` (R, N) i32 counts the parents not yet terminal,
    ``failed`` (R, N) bool is True where some parent terminated without
    completing (such a task can never run)."""
    idx, valid = dep_index(parents) if index is None else index
    ps = status.gather(1, idx).view(parents.shape)
    term = valid & (ps >= COMPLETED)
    left = (valid & ~term).sum(2, dtype=torch.int32)
    failed = (term & (ps != COMPLETED)).any(2)
    return left, failed


def is_terminal(status: torch.Tensor) -> torch.Tensor:
    return status >= COMPLETED


def init_state(tasks: TaskTable, mtype: torch.Tensor,
               dynamics: MachineDynamics | None = None,
               parents: torch.Tensor | None = None) -> SimState:
    """Initial state of every replica: all tasks NOT_ARRIVED, all
    machines idle, at the DVFS point of ``dynamics`` (full speed and
    nominal power without one); with an (R, N, K) ``parents`` table,
    ``deps_left`` counts each task's parents."""
    r, n = tasks.arrival.shape
    m = mtype.shape[-1]
    dev = tasks.arrival.device

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if dynamics is None:
        speed = full((r, m), 1.0, torch.float32)
        power_scale = full((r, m), 1.0, torch.float32)
    else:
        speed = dynamics.speed.to(torch.float32).clone()
        power_scale = dynamics.power_scale.to(torch.float32).clone()
    machines = MachineState(
        mtype=mtype.to(torch.int32),
        running=full((r, m), -1, torch.int32),
        busy_until=full((r, m), 0.0, torch.float32),
        active_time=full((r, m), 0.0, torch.float32),
        energy=full((r, m), 0.0, torch.float32),
        speed=speed,
        power_scale=power_scale,
    )
    table = TaskTable(
        arrival=tasks.arrival.to(torch.float32),
        type_id=tasks.type_id.to(torch.int32),
        deadline=tasks.deadline.to(torch.float32),
        status=full((r, n), NOT_ARRIVED, torch.int32),
        machine=full((r, n), -1, torch.int32),
        seq=full((r, n), INT_MAX, torch.int32),
        t_start=full((r, n), -1.0, torch.float32),
        t_end=full((r, n), -1.0, torch.float32),
    )
    return SimState(
        time=full((r,), 0.0, torch.float32),
        tasks=table,
        machines=machines,
        seq_counter=full((r,), 0, torch.int32),
        rr_ptr=full((r,), 0, torch.int32),
        n_events=full((r,), 0, torch.int32),
        n_preempts=full((r, n), 0, torch.int32),
        mq_count=full((r, m), 0, torch.int32),
        n_batch=full((r,), 0, torch.int32),
        n_live=full((r,), n, torch.int32),
        deps_left=None if parents is None
        else (parents >= 0).sum(2, dtype=torch.int32),
    )


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def exec_time(tables: StaticTables, tasks: TaskTable, task_id: torch.Tensor,
              mtype: torch.Tensor, speed: torch.Tensor) -> torch.Tensor:
    """Actual execution time of ``task_id`` (R, K) on machines of type
    ``mtype`` (R, K) at ``speed`` (R, K): ``eet * noise / speed``, in the
    reference's order."""
    r = _rows(task_id)[:, None]
    task_id = task_id.long()
    ttype = tasks.type_id.gather(1, task_id).long()
    return tables.eet[r, ttype, mtype.long()] * \
        tables.noise.gather(1, task_id) / speed


def expected_nm(tables: StaticTables, tasks: TaskTable,
                machines: MachineState) -> torch.Tensor:
    """(R, N, M) expected execution time of every task on every machine
    (EET gathered by task and machine type, divided by machine speed)."""
    r = _rows(tasks.type_id)[:, None, None]
    return tables.eet[r, tasks.type_id.long()[:, :, None],
                      machines.mtype.long()[:, None, :]] \
        / machines.speed[:, None, :]


def queued_mask(tasks: TaskTable, n_machines: int) -> torch.Tensor:
    """(R, N, M) bool: task n waits in machine m's queue."""
    ids = torch.arange(n_machines, device=tasks.machine.device)
    return (tasks.status == IN_MQ)[:, :, None] & (
        tasks.machine[:, :, None] == ids)


def queue_counts(tasks: TaskTable, n_machines: int) -> torch.Tensor:
    """(R, M) number of tasks waiting in each machine queue."""
    return queued_mask(tasks, n_machines).sum(1, dtype=torch.int32)


def queued_work(tasks: TaskTable, tables: StaticTables,
                machines: MachineState) -> torch.Tensor:
    """(R, M) total expected work waiting in each machine queue, summed
    over tasks in the reference's order."""
    eet_nm = expected_nm(tables, tasks, machines)
    mask = queued_mask(tasks, machines.mtype.shape[-1])
    return ordered_sum(torch.where(mask, eet_nm, 0.0), 1)


def machine_available(state: SimState, tables: StaticTables) -> torch.Tensor:
    """(R, M) earliest time each machine could start a *new* task."""
    mach = state.machines
    t = state.time[:, None]
    base = torch.maximum(t, torch.where(mach.running >= 0, mach.busy_until,
                                        t))
    return base + queued_work(state.tasks, tables, mach)
