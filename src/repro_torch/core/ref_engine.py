"""Plain-Python event loop of the E2C semantics, for the serving engine.

A numpy copy of ``repro/core/ref_engine.py``'s ``_Sim`` and
``simulate_ref``, limited to what ``serving.ServingEngine`` runs:
independent tasks, a static fleet and the ten heuristics, with no trace,
metrics, streaming window or learned policy.  The float64 arithmetic and
every tie-break are the reference's, so for the same inputs every result
is equal to the reference's, not close: a static fleet's speed and power
multipliers are 1.0, whose division and product the copy leaves out as
exact.

Tie-breaking: lowest task id first, lowest machine id first, row-major
(task-major) for pair policies.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import state as S

BIG = 1e30
POLICIES = ("fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
            "maxmin", "edf_mct", "heft")


@dataclass
class RefResult:
    status: np.ndarray
    machine: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    active_energy: np.ndarray     # (M,)
    active_time: np.ndarray       # (M,)
    makespan: float
    n_events: int = 0             # processed event-loop trips


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
        if self.policy not in POLICIES:
            raise ValueError(f"unknown or unported policy {self.policy!r}; "
                             f"the port's reference loop has {POLICIES}")
        n, m = len(self.arrival), len(self.mtype)
        self.rank = np.zeros(n, np.float64)
        self.status = np.full(n, S.NOT_ARRIVED, np.int32)
        self.machine = np.full(n, -1, np.int32)
        self.seq = np.full(n, np.iinfo(np.int32).max, np.int64)
        self.t_start = np.full(n, -1.0, np.float64)
        self.t_end = np.full(n, -1.0, np.float64)
        self.running = np.full(m, -1, np.int32)
        self.busy_until = np.zeros(m, np.float64)
        self.energy = np.zeros(m, np.float64)
        self.active_time = np.zeros(m, np.float64)

    # ---- helpers ---------------------------------------------------------
    def exec_time(self, t: int, m: int) -> float:
        return float(self.eet[self.type_id[t], self.mtype[m]]
                     * self.noise[t])

    def expected(self, t: int, m: int) -> float:
        return float(self.eet[self.type_id[t], self.mtype[m]])

    def p_active(self, m: int) -> float:
        return float(self.power[self.mtype[m], 1])

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

    # ---- event phases ----------------------------------------------------
    def completions(self):
        for m in range(len(self.mtype)):
            t = self.running[m]
            if t >= 0 and self.busy_until[m] <= self.time:
                dur = self.busy_until[m] - self.t_start[t]
                self.status[t] = S.COMPLETED
                self.t_end[t] = self.busy_until[m]
                self.energy[m] += self.p_active(m) * dur
                self.active_time[m] += dur
                self.running[m] = -1

    def arrivals(self):
        new = np.nonzero((self.status == S.NOT_ARRIVED)
                         & (self.arrival <= self.time))[0]
        n_in_batch = int((self.status == S.IN_BATCH).sum())
        for k, t in enumerate(sorted(new)):
            if n_in_batch + k + 1 <= self.qcap:
                self.status[t] = S.IN_BATCH
            else:
                self.status[t] = S.CANCELLED
                self.t_end[t] = self.arrival[t]

    def deadline_drops(self):
        for t in range(len(self.arrival)):
            if self.status[t] in (S.IN_BATCH, S.IN_MQ) \
                    and self.deadline[t] <= self.time:
                self.status[t] = S.MISSED_QUEUE
                self.t_end[t] = self.deadline[t]
        for m in range(len(self.mtype)):
            t = self.running[m]
            if t >= 0 and self.deadline[t] <= self.time:
                dur = self.deadline[t] - self.t_start[t]
                self.status[t] = S.MISSED_RUNNING
                self.t_end[t] = self.deadline[t]
                self.energy[m] += self.p_active(m) * dur
                self.active_time[m] += dur
                self.running[m] = -1

    # ---- scheduler -------------------------------------------------------
    def decide(self):
        """Returns (task, machine) or None; the reference's rules."""
        q = self.batch_queue()
        rooms = [m for m in range(len(self.mtype)) if self.room(m)]
        if not q or not rooms:
            return None
        head = q[0]
        avail = {m: self.avail(m) for m in rooms}
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
            return min(((t, m) for t in q for m in rooms),
                       key=lambda tm: (avail[tm[1]]
                                       + self.expected(*tm), tm[0], tm[1]))
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
        # heft: highest upward rank; independent tasks all rank 0
        t = max(q, key=lambda t: (self.rank[t], -t))
        m = min(rooms, key=lambda m: (avail[m] + self.expected(t, m), m))
        return t, m

    def drain(self):
        while True:
            dec = self.decide()
            if dec is None:
                break
            t, m = dec
            rooms = [mm for mm in range(len(self.mtype)) if self.room(mm)]
            best = min(self.avail(mm) + self.expected(t, mm) for mm in rooms)
            if self.cancel_infeasible and best > self.deadline[t]:
                self.status[t] = S.CANCELLED
                self.t_end[t] = self.time
            else:
                self.status[t] = S.IN_MQ
                self.machine[t] = m
                self.seq[t] = self.seq_counter
                self.seq_counter += 1
                self.rr_ptr = (m + 1) % len(self.mtype)

    def start_tasks(self):
        for m in range(len(self.mtype)):
            if self.running[m] < 0:
                queue = self.queue_of(m)
                if queue:
                    t = queue[0]
                    self.status[t] = S.RUNNING
                    self.t_start[t] = self.time
                    self.busy_until[m] = self.time + self.exec_time(t, m)
                    self.running[m] = t

    # ---- loop ------------------------------------------------------------
    def next_event(self) -> float:
        cands = []
        na = self.arrival[self.status == S.NOT_ARRIVED]
        if na.size:
            cands.append(na.min())
        bu = self.busy_until[self.running >= 0]
        if bu.size:
            cands.append(bu.min())
        live = np.isin(self.status, (S.IN_BATCH, S.IN_MQ, S.RUNNING))
        dl = self.deadline[live]
        if dl.size:
            cands.append(dl.min())
        return min(cands) if cands else np.inf

    def run(self, max_events: int | None = None) -> RefResult:
        n = len(self.arrival)
        # the reference's budget with a static fleet's one (inf) interval
        budget = max_events or (4 * n + 16 + 2 * len(self.mtype))
        n_events = 0
        while not np.all(self.status >= S.COMPLETED) and budget > 0:
            t = self.next_event()
            if not np.isfinite(t):
                break
            self.time = max(t, self.time)
            self.completions()
            self.arrivals()
            self.deadline_drops()
            self.drain()
            self.start_tasks()
            budget -= 1
            n_events += 1
        return RefResult(self.status.copy(), self.machine.copy(),
                         self.t_start.copy(), self.t_end.copy(),
                         self.energy.copy(), self.active_time.copy(),
                         float(max(self.t_end.max(), 0.0)), n_events)


def simulate_ref(arrival, type_id, deadline, eet, power, mtype, *,
                 policy="mct", lcap=4, qcap=1 << 30,
                 cancel_infeasible=True, noise=None,
                 max_events=None) -> RefResult:
    """One run of the reference loop on a static fleet."""
    arrival = np.asarray(arrival, np.float64)
    if noise is None:
        noise = np.ones(len(arrival))
    sim = _Sim(arrival, np.asarray(type_id, np.int64),
               np.asarray(deadline, np.float64),
               np.asarray(eet, np.float64), np.asarray(power, np.float64),
               np.asarray(mtype, np.int64), np.asarray(noise, np.float64),
               policy, lcap, qcap, cancel_infeasible)
    return sim.run(max_events)
