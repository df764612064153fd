"""Plain-Python event loop of the E2C semantics: the port's oracle.

A numpy copy of ``repro/core/ref_engine.py``'s ``_Sim`` and
``simulate_ref``, in the most readable form (dicts and lists, no
PyTorch): the ten heuristics and the learned ``mlp``/``linear`` policies
(their float32 numpy forward pass, ``neural.score_machines_np``), on
independent tasks or a workflow (``parents`` and HEFT ``rank``), densely
or through the streaming window (``window=W``: at most W tasks loaded
and not retired, loaded in id order as slots retire), on a static or a
dynamic fleet (DVFS ``speed`` and ``power_scale``, down intervals
``down_start``/``down_end`` and spot ``kill``), with the
``(time, kind, task, machine)`` trace rows (``trace=True``, the event
kinds of ``core/trace.py``, in the order the engine records them) and
the tail metrics (``metrics=True``, ``core/metrics.py::fold_tasks_np``
over the final table and a queue-depth sample per processed event).
The float64 arithmetic and every tie-break are the reference's, so for
the same inputs every ``RefResult`` field is equal to the reference's,
not close.  ``serving.ServingEngine`` runs its scheduler on ``_Sim``.

Tie-breaking: lowest task id first, lowest machine id first, row-major
(task-major) for pair policies.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import metrics as ME
from repro_torch.core import neural as NN
from repro_torch.core import state as S
from repro_torch.core import trace as TR

BIG = 1e30
POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft") + NN.LEARNED_POLICIES


@dataclass
class RefResult:
    status: np.ndarray
    machine: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    active_energy: np.ndarray     # (M,)
    active_time: np.ndarray       # (M,)
    makespan: float
    n_preempts: np.ndarray | None = None    # (N,) forced evictions
    trace: list[tuple] | None = None        # (time, kind, task, machine)
    #      rows in the exact order the engine records them
    metrics: dict | None = None             # metrics.fold_tasks_np counts
    #      dict (same schema/keys as metrics.to_numpy) when the run was
    #      instrumented — the oracle for SimParams(metrics=True)
    n_events: int = 0                       # processed event-loop trips —
    #      the oracle for SimState.n_events (loop-trip accounting)


@dataclass
class _Sim:
    arrival: np.ndarray
    type_id: np.ndarray
    deadline: np.ndarray
    eet: np.ndarray               # (T, Mt)
    power: np.ndarray             # (Mt, 2)
    mtype: np.ndarray             # (M,)
    noise: np.ndarray             # (N,)
    policy: str
    lcap: int
    qcap: int
    cancel_infeasible: bool
    # dynamic scenario (see state.MachineDynamics); defaults = static fleet
    speed: np.ndarray | None = None          # (M,) DVFS speed multiplier
    power_scale: np.ndarray | None = None    # (M,) DVFS power multiplier
    down_start: np.ndarray | None = None     # (M, K) inf-padded
    down_end: np.ndarray | None = None       # (M, K)
    kill: np.ndarray | None = None           # (M,) bool
    trace: list[tuple] | None = None         # enabled by simulate_ref
    # learned-policy weights (numpy float32 dict from neural.params_to_numpy;
    # None = the engine's zero default)
    policy_params: dict | None = None
    # workflow mode (see engine._release / docs/workflows.md)
    parents: np.ndarray | None = None        # (N, K) i32, -1 padded
    rank: np.ndarray | None = None           # (N,) HEFT upward ranks
    # streaming mode (see core/streaming.py / docs/streaming.md): at most
    # ``window`` tasks are live at once; the rest of the stream loads in
    # id order as slots retire.  None = dense semantics (all loaded).
    window: int | None = None
    # telemetry mirror (see core/metrics.py / docs/observability.md):
    # a queue-depth sample per processed event, per-task histograms +
    # SLO windows folded over the final table.  None = uninstrumented.
    metrics_spec: ME.MetricsSpec | None = None

    status: np.ndarray = field(init=False)
    machine: np.ndarray = field(init=False)
    seq: np.ndarray = field(init=False)
    t_start: np.ndarray = field(init=False)
    t_end: np.ndarray = field(init=False)
    running: np.ndarray = field(init=False)       # (M,) task or -1
    busy_until: np.ndarray = field(init=False)
    energy: np.ndarray = field(init=False)
    active_time: np.ndarray = field(init=False)
    time: float = 0.0
    seq_counter: int = 0
    rr_ptr: int = 0

    def __post_init__(self):
        n, m = len(self.arrival), len(self.mtype)
        if self.policy not in POLICIES:
            raise ValueError(f"unknown or unported policy {self.policy!r}; "
                             f"the port's reference loop has {POLICIES}")
        if self.speed is None:
            self.speed = np.ones(m)
        if self.power_scale is None:
            self.power_scale = np.ones(m)
        if self.down_start is None:
            self.down_start = np.full((m, 1), np.inf)
        if self.down_end is None:
            self.down_end = np.full((m, 1), np.inf)
        if self.kill is None:
            self.kill = np.zeros(m, bool)
        if self.policy_params is None:
            self.policy_params = NN.params_to_numpy(None)
        if self.rank is None:
            self.rank = np.zeros(n, np.float64)
        self.n_preempts = np.zeros(n, np.int32)
        self.status = np.full(n, S.NOT_ARRIVED, np.int32)
        self.machine = np.full(n, -1, np.int32)
        self.seq = np.full(n, np.iinfo(np.int32).max, np.int64)
        self.t_start = np.full(n, -1.0, np.float64)
        self.t_end = np.full(n, -1.0, np.float64)
        self.running = np.full(m, -1, np.int32)
        self.busy_until = np.zeros(m, np.float64)
        self.energy = np.zeros(m, np.float64)
        self.active_time = np.zeros(m, np.float64)
        self.qdepth_counts = None if self.metrics_spec is None else \
            np.zeros(self.metrics_spec.buckets + 2, np.int64)
        # streaming-window bookkeeping (all-loaded when window is None)
        self.loaded = np.full(n, self.window is None, bool)
        self.retired = np.zeros(n, bool)
        self.children: dict[int, list[int]] = {}
        if self.parents is not None:
            for t in range(n):
                for p in self.parents[t]:
                    if p >= 0:
                        self.children.setdefault(int(p), []).append(t)

    # ---- helpers ---------------------------------------------------------
    def exec_time(self, t: int, m: int) -> float:
        return float(self.eet[self.type_id[t], self.mtype[m]]
                     * self.noise[t] / self.speed[m])

    def expected(self, t: int, m: int) -> float:
        return float(self.eet[self.type_id[t], self.mtype[m]]
                     / self.speed[m])

    def p_active(self, m: int) -> float:
        return float(self.power[self.mtype[m], 1] * self.power_scale[m])

    def up(self, m: int) -> bool:
        return not np.any((self.down_start[m] <= self.time)
                          & (self.time < self.down_end[m]))

    def emit(self, kind: int, t: int, m: int):
        """Trace hook: same rows, same order as engine.py's T.record."""
        if self.trace is not None:
            self.trace.append((float(self.time), int(kind), int(t), int(m)))

    def queue_of(self, m: int) -> list[int]:
        ids = np.nonzero((self.status == S.IN_MQ) & (self.machine == m))[0]
        return sorted(ids, key=lambda i: self.seq[i])

    def room(self, m: int) -> bool:
        return len(self.queue_of(m)) < self.lcap

    def avail(self, m: int) -> float:
        base = self.time
        if self.running[m] >= 0:
            base = max(base, self.busy_until[m])
        return base + sum(self.expected(t, m) for t in self.queue_of(m))

    def batch_queue(self) -> list[int]:
        return list(np.nonzero(self.status == S.IN_BATCH)[0])

    # ---- streaming window (mirror of streaming._retire/_refill) ----------
    def _retire_window(self):
        """A slot retires when its task is terminal and — in workflow
        mode — every child is loaded and no loaded child is still
        NOT_ARRIVED (children read the parent's terminal status until
        they arrive or are cascade-cancelled)."""
        for t in range(len(self.arrival)):
            if self.retired[t] or not self.loaded[t] \
                    or self.status[t] < S.COMPLETED:
                continue
            kids = self.children.get(t, [])
            if any(not self.loaded[c] for c in kids):
                continue
            if any(self.status[c] == S.NOT_ARRIVED for c in kids):
                continue
            self.retired[t] = True

    def stream_load(self):
        """Retire eligible slots, then load pending tasks in id order
        while the window has room — the eager-refill rule of
        ``streaming.run_stream`` (loaded ids are a stream prefix)."""
        if self.window is None:
            return
        self._retire_window()
        occ = int((self.loaded & ~self.retired).sum())
        for t in range(len(self.arrival)):
            if occ >= self.window:
                break
            if not self.loaded[t]:
                self.loaded[t] = True
                occ += 1

    # ---- event phases ----------------------------------------------------
    def completions(self):
        for m in range(len(self.mtype)):
            t = self.running[m]
            if t >= 0 and self.busy_until[m] <= self.time:
                dur = self.busy_until[m] - self.t_start[t]
                self.emit(TR.EV_COMPLETE, t, m)
                self.status[t] = S.COMPLETED
                self.t_end[t] = self.busy_until[m]
                self.energy[m] += self.p_active(m) * dur
                self.active_time[m] += dur
                self.running[m] = -1

    def availability(self):
        """Machines inside a down interval evict running + queued work.

        Two passes — running tasks in machine-id order, then queued
        tasks in task-id order — matching the engine's two masked
        scatters, so the emitted trace rows line up exactly.  (The
        per-machine updates are independent, so the final state is the
        same either way.)
        """
        for m in range(len(self.mtype)):
            if self.up(m):
                continue
            t = self.running[m]
            if t >= 0:
                dur = self.time - self.t_start[t]
                self.emit(TR.EV_PREEMPT if self.kill[m] else TR.EV_REQUEUE,
                          t, m)
                self.energy[m] += self.p_active(m) * dur
                self.active_time[m] += dur
                self.running[m] = -1
                self.n_preempts[t] += 1
                if self.kill[m]:
                    self.status[t] = S.PREEMPTED
                    self.t_end[t] = self.time
                else:
                    self.status[t] = S.IN_BATCH
                    self.machine[t] = -1
                    self.seq[t] = np.iinfo(np.int32).max
                    self.t_start[t] = -1.0
        for t in range(len(self.arrival)):
            m = self.machine[t]
            if self.status[t] != S.IN_MQ or m < 0 or self.up(m):
                continue
            self.emit(TR.EV_PREEMPT if self.kill[m] else TR.EV_REQUEUE,
                      t, m)
            self.n_preempts[t] += 1
            if self.kill[m]:
                self.status[t] = S.PREEMPTED
                self.t_end[t] = self.time
            else:
                self.status[t] = S.IN_BATCH
                self.machine[t] = -1
                self.seq[t] = np.iinfo(np.int32).max

    def _parents_of(self, t: int) -> list[int]:
        if self.parents is None:
            return []
        return [int(p) for p in self.parents[t] if p >= 0]

    def released(self, t: int) -> bool:
        """All parents terminal (workflow mode; trivially true without)."""
        return all(self.status[p] >= S.COMPLETED
                   for p in self._parents_of(t))

    def dep_failed(self, t: int) -> bool:
        return any(self.status[p] >= S.COMPLETED
                   and self.status[p] != S.COMPLETED
                   for p in self._parents_of(t))

    def release(self):
        """Workflow phase (mirrors ``engine._release``): cancel tasks
        whose precedence constraint can never be satisfied, cascading to
        a fixpoint; cancels are emitted once, in task-id order, exactly
        like the engine's status-diff record."""
        if self.parents is None:
            return
        cancelled: list[int] = []
        changed = True
        while changed:
            changed = False
            for t in range(len(self.arrival)):
                if self.status[t] != S.NOT_ARRIVED or not self.loaded[t]:
                    continue
                if self.released(t) and self.dep_failed(t):
                    self.status[t] = S.CANCELLED
                    self.t_end[t] = self.time
                    cancelled.append(t)
                    changed = True
        for t in sorted(cancelled):
            self.emit(TR.EV_CANCEL, t, -1)

    def arrivals(self):
        new = np.nonzero((self.status == S.NOT_ARRIVED) & self.loaded
                         & (self.arrival <= self.time))[0]
        new = [t for t in new if self.released(t)]
        n_in_batch = int((self.status == S.IN_BATCH).sum())
        for k, t in enumerate(sorted(new)):
            if n_in_batch + k + 1 <= self.qcap:
                self.status[t] = S.IN_BATCH
            else:
                self.emit(TR.EV_CANCEL, t, -1)
                self.status[t] = S.CANCELLED
                self.t_end[t] = self.arrival[t]

    def deadline_drops(self):
        for t in range(len(self.arrival)):
            if self.status[t] in (S.IN_BATCH, S.IN_MQ) \
                    and self.deadline[t] <= self.time:
                self.emit(TR.EV_MISS_QUEUE, t, self.machine[t])
                self.status[t] = S.MISSED_QUEUE
                self.t_end[t] = self.deadline[t]
        for m in range(len(self.mtype)):
            t = self.running[m]
            if t >= 0 and self.deadline[t] <= self.time:
                dur = self.deadline[t] - self.t_start[t]
                self.emit(TR.EV_MISS_RUNNING, t, m)
                self.status[t] = S.MISSED_RUNNING
                self.t_end[t] = self.deadline[t]
                self.energy[m] += self.p_active(m) * dur
                self.active_time[m] += dur
                self.running[m] = -1

    # ---- scheduler -------------------------------------------------------
    def _learned_scores(self, t: int) -> np.ndarray:
        """(M,) learned-policy scores for mapping task ``t`` to each
        machine — the numpy mirror of ``neural.machine_features`` +
        forward pass (float32, the reference's op order)."""
        n_m = len(self.mtype)
        eet_row = np.array([self.expected(t, m) for m in range(n_m)],
                           np.float32)
        en_row = np.array([self.expected(t, m) * self.p_active(m)
                           for m in range(n_m)], np.float32)
        avail = np.array([self.avail(m) for m in range(n_m)], np.float32)
        mq = np.array([len(self.queue_of(m)) for m in range(n_m)],
                      np.float32)
        room = np.array([self.room(m) and self.up(m) for m in range(n_m)],
                        bool)
        feats = NN.machine_features_np(eet_row, en_row, avail, self.time,
                                       self.deadline[t], mq, room)
        return NN.score_machines_np(self.policy_params, feats, self.policy)

    def decide(self):
        """Returns (task, machine) or None; mirrors schedulers.py exactly."""
        q = self.batch_queue()
        rooms = [m for m in range(len(self.mtype))
                 if self.room(m) and self.up(m)]
        if not q or not rooms:
            return None
        head = q[0]
        avail = {m: self.avail(m) for m in rooms}
        if self.policy in ("mlp", "linear"):
            scores = self._learned_scores(head)
            m = min(rooms, key=lambda m: (scores[m], m))
            return head, m
        if self.policy == "fcfs":
            m = min(rooms, key=lambda m: (avail[m], m))
            return head, m
        if self.policy == "rr":
            n_m = len(self.mtype)
            for k in range(n_m):
                m = (self.rr_ptr + k) % n_m
                if m in rooms:
                    return head, m
        if self.policy == "met":
            m = min(rooms, key=lambda m: (self.expected(head, m), m))
            return head, m
        if self.policy == "mct":
            m = min(rooms, key=lambda m: (avail[m] + self.expected(head, m),
                                          m))
            return head, m
        if self.policy == "ee_met":
            m = min(rooms, key=lambda m: (
                self.expected(head, m) * self.p_active(m), m))
            return head, m
        if self.policy == "ee_mct":
            feas = [m for m in rooms
                    if avail[m] + self.expected(head, m)
                    <= self.deadline[head]]
            if feas:
                m = min(feas, key=lambda m: (
                    self.expected(head, m) * self.p_active(m), m))
            else:
                m = min(rooms, key=lambda m: (
                    avail[m] + self.expected(head, m), m))
            return head, m
        if self.policy == "minmin":
            best = min(((t, m) for t in q for m in rooms),
                       key=lambda tm: (avail[tm[1]]
                                       + self.expected(*tm), tm[0], tm[1]))
            return best
        if self.policy == "maxmin":
            def best_for(t):
                return min(rooms, key=lambda m: (avail[m]
                                                 + self.expected(t, m), m))
            t = max(q, key=lambda t: (avail[best_for(t)]
                                      + self.expected(t, best_for(t)), -t))
            return t, best_for(t)
        if self.policy == "edf_mct":
            t = min(q, key=lambda t: (self.deadline[t], t))
            m = min(rooms, key=lambda m: (avail[m] + self.expected(t, m), m))
            return t, m
        if self.policy == "heft":
            t = max(q, key=lambda t: (self.rank[t], -t))
            m = min(rooms, key=lambda m: (avail[m] + self.expected(t, m), m))
            return t, m
        raise ValueError(f"unknown policy {self.policy}")

    def drain(self):
        cancelled: list[int] = []
        while True:
            dec = self.decide()
            if dec is None:
                break
            t, m = dec
            rooms = [mm for mm in range(len(self.mtype))
                     if self.room(mm) and self.up(mm)]
            best = min(self.avail(mm) + self.expected(t, mm) for mm in rooms)
            if self.cancel_infeasible and best > self.deadline[t]:
                cancelled.append(t)
                self.status[t] = S.CANCELLED
                self.t_end[t] = self.time
            else:
                self.status[t] = S.IN_MQ
                self.machine[t] = m
                self.seq[t] = self.seq_counter
                self.seq_counter += 1
                self.rr_ptr = (m + 1) % len(self.mtype)
        # engine.py records drain cancels once per event via a status
        # diff (task-id order), not per drain iteration — mirror that
        for t in sorted(cancelled):
            self.emit(TR.EV_CANCEL, t, -1)

    def start_tasks(self):
        for m in range(len(self.mtype)):
            if self.running[m] < 0 and self.up(m):
                queue = self.queue_of(m)
                if queue:
                    t = queue[0]
                    self.emit(TR.EV_START, t, m)
                    self.status[t] = S.RUNNING
                    self.t_start[t] = self.time
                    self.busy_until[m] = self.time + self.exec_time(t, m)
                    self.running[m] = t

    # ---- loop ------------------------------------------------------------
    def next_event(self) -> float:
        cands = []
        waiting = np.nonzero((self.status == S.NOT_ARRIVED)
                             & self.loaded)[0]
        if self.parents is None:
            na = self.arrival[waiting]
        else:
            # dependency-blocked tasks have no pending arrival event (a
            # parent's terminal transition is already a candidate); a
            # pending failure-release cascade fires at the current time
            na = np.array([self.arrival[t] for t in waiting
                           if self.released(t) and not self.dep_failed(t)])
            if any(self.released(t) and self.dep_failed(t)
                   for t in waiting):
                cands.append(self.time)
        if na.size:
            cands.append(na.min())
        bu = self.busy_until[self.running >= 0]
        if bu.size:
            cands.append(bu.min())
        live = np.isin(self.status, (S.IN_BATCH, S.IN_MQ, S.RUNNING))
        dl = self.deadline[live]
        if dl.size:
            cands.append(dl.min())
        trans = np.concatenate([self.down_start.ravel(),
                                self.down_end.ravel()])
        trans = trans[(trans > self.time) & np.isfinite(trans)]
        if trans.size:
            cands.append(trans.min())
        return min(cands) if cands else np.inf

    def run(self, max_events: int | None = None) -> RefResult:
        n = len(self.arrival)
        budget = max_events or (4 * n + 16
                                + 2 * self.down_start.shape[-1]
                                * len(self.mtype)
                                + (n if self.parents is not None else 0))
        n_events = 0
        while not np.all(self.status >= S.COMPLETED) and budget > 0:
            self.stream_load()
            t = self.next_event()
            if not np.isfinite(t):
                break
            # late-loaded tasks may carry past arrivals: clamp instead of
            # running time backwards (a no-op in dense / N <= W mode)
            self.time = max(t, self.time)
            self.completions()
            self.availability()
            self.release()
            self.arrivals()
            self.deadline_drops()
            self.drain()
            self.start_tasks()
            if self.qdepth_counts is not None:
                # one sample per processed event, after all phases —
                # the mirror of engine.py's ME.observe_event
                depth = int(np.isin(self.status,
                                    (S.IN_BATCH, S.IN_MQ)).sum())
                self.qdepth_counts[
                    ME.bucket_np(self.metrics_spec, depth)] += 1
            budget -= 1
            n_events += 1
        metrics = None
        if self.metrics_spec is not None:
            metrics = ME.fold_tasks_np(
                self.metrics_spec, self.status, self.arrival,
                self.t_start, self.t_end, self.qdepth_counts)
        return RefResult(self.status.copy(), self.machine.copy(),
                         self.t_start.copy(), self.t_end.copy(),
                         self.energy.copy(), self.active_time.copy(),
                         float(max(self.t_end.max(), 0.0)),
                         self.n_preempts.copy(),
                         None if self.trace is None else list(self.trace),
                         metrics, n_events)


def simulate_ref(arrival, type_id, deadline, eet, power, mtype, *,
                 policy="mct", lcap=4, qcap=1 << 30,
                 cancel_infeasible=True, noise=None,
                 speed=None, power_scale=None, down_start=None,
                 down_end=None, kill=None,
                 max_events=None, trace=False,
                 policy_params=None, parents=None,
                 rank=None, window=None, metrics=False,
                 metrics_spec=None) -> RefResult:
    """Oracle run.  The ``speed``/``power_scale``/``down_*``/``kill``
    kwargs mirror ``state.MachineDynamics`` (all default to the static
    fleet).  ``trace=True`` collects the ``(time, kind, task, machine)``
    event stream in the same order the engine records it —
    ``tests/test_torch_ref_oracle.py`` asserts the two streams are
    identical.
    ``policy_params`` takes a ``neural.PolicyParams`` pytree (or the dict
    from ``neural.params_to_numpy``) for the learned ``mlp``/``linear``
    policies; omitted = the engine's zero default.  ``parents``/``rank``
    mirror ``run_sim(parents=...)`` + ``StaticTables.rank`` (workflow
    mode — pass the *same* float32 ranks the engine gets, so the ``heft``
    orderings agree bit-for-bit).  ``window=W`` enables the streaming
    mirror: at most W tasks are live at once, refilled in id order as
    slots retire — the oracle for ``streaming.run_stream`` when N > W.
    ``metrics=True`` mirrors ``SimParams(metrics=True)``: the returned
    ``RefResult.metrics`` counts dict (``metrics.fold_tasks_np`` schema,
    samples cast to float32 before bucketing) must equal the engine's
    histograms bit-for-bit — ``tests/test_torch_ref_oracle.py`` asserts
    it."""
    arrival = np.asarray(arrival, np.float64)
    if noise is None:
        noise = np.ones(len(arrival))
    def _f64(x):
        return None if x is None else np.asarray(x, np.float64)
    if policy_params is not None and not isinstance(policy_params, dict):
        policy_params = NN.params_to_numpy(policy_params)
    sim = _Sim(arrival, np.asarray(type_id, np.int64),
               np.asarray(deadline, np.float64),
               np.asarray(eet, np.float64), np.asarray(power, np.float64),
               np.asarray(mtype, np.int64), np.asarray(noise, np.float64),
               policy, lcap, qcap, cancel_infeasible,
               speed=_f64(speed), power_scale=_f64(power_scale),
               down_start=_f64(down_start), down_end=_f64(down_end),
               kill=None if kill is None else np.asarray(kill, bool),
               trace=[] if trace else None,
               policy_params=policy_params,
               parents=None if parents is None
               else np.asarray(parents, np.int32),
               rank=_f64(rank), window=window,
               metrics_spec=(metrics_spec or ME.DEFAULT_SPEC) if metrics
               else None)
    return sim.run(max_events)
