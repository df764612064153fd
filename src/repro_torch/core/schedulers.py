"""Scheduling policies, batched over replicas.

The counterpart of ``repro.core.schedulers``: the ten heuristics
``fcfs, rr, met, mct, ee_met, ee_mct, minmin, maxmin, edf_mct, heft``
with the reference's policy ids, the cancellation wrapper and
``dispatch``.  The learned ``mlp``/``linear`` policies keep their ids
but raise ``NotImplementedError``; they never fall back to another
policy.  Down machines of a dynamic fleet have no ``room``, so every
policy is failure-aware through the view.

The reference evaluates one replica at a time and picks the policy with
``lax.switch``.  Here one call decides for all R replicas at once, each
with its own policy.  The immediate policies (every one but ``rr`` and
``minmin``) share a shape — pick a task, score the machines, take the
masked argmin — so each returns its task and (R, M) score and mask rows,
``dispatch`` selects the rows by policy id and reduces them with ONE
``masked_argmin`` for the whole batch; ``minmin`` and ``maxmin`` run
their fused kernels on the replicas that use them.  Every replica's
decision is the one its
``lax.switch`` branch takes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core import state as S
from repro_torch.kernels import sched_argmin as K

BIG = 1e30

POLICY_NAMES = ["fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
                "maxmin", "edf_mct", "heft", "mlp", "linear"]
POLICY_IDS = {name: i for i, name in enumerate(POLICY_NAMES)}
NOT_PORTED = {
    "mlp": "learned policies are not ported yet (ROADMAP.md, queue A "
           "item 14)",
    "linear": "learned policies are not ported yet (ROADMAP.md, queue A "
              "item 14)",
}


class Decision(NamedTuple):
    task: torch.Tensor      # i32 (R,) task id, -1 = no-op
    machine: torch.Tensor   # i32 (R,) machine id, -1 = no-op
    cancel: torch.Tensor    # bool (R,) cancel instead of map


class SchedView(NamedTuple):
    """Tensors shared by all policies, built once per drain trip."""
    in_batch: torch.Tensor   # bool (R, N)
    room: torch.Tensor       # bool (R, M)  queue has space AND is up
    avail: torch.Tensor      # f32 (R, M)   earliest start for new work
    eet_nm: torch.Tensor     # f32 (R, N, M) expected exec time
    energy_nm: torch.Tensor  # f32 (R, N, M) eet * active power
    head: torch.Tensor       # i32 (R,)     FIFO head of batch queue, -1
    any_room: torch.Tensor   # bool (R,)
    rank: torch.Tensor       # f32 (R, N)   HEFT upward rank

    def row(self, table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(R, M) row ``t`` (R,) of an (R, N, M) table; -1 reads row 0
        (the reference's reads there are masked out the same way)."""
        r = torch.arange(t.shape[0], device=t.device)
        return table[r, t.clamp(min=0).long()]

    def completion_row(self, t: torch.Tensor) -> torch.Tensor:
        """(R, M) expected completion of task ``t`` on each machine."""
        return self.avail + self.row(self.eet_nm, t)


def expected_tables(state: S.SimState, tables: S.StaticTables
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The run-invariant (R, N, M) expected-time and energy matrices."""
    mach = state.machines
    eet_nm = S.expected_nm(tables, state.tasks, mach)
    r = torch.arange(mach.mtype.shape[0], device=mach.mtype.device)[:, None]
    p_active = tables.power[r, mach.mtype.long(), 1] * mach.power_scale
    return eet_nm, eet_nm * p_active[:, None, :]


def build_view(state: S.SimState, tables: S.StaticTables, lcap: int,
               const: tuple | None = None,
               avail: torch.Tensor | None = None,
               up: torch.Tensor | None = None) -> SchedView:
    """``const``: optional precomputed (eet_nm, energy_nm); ``avail``:
    optional carried (R, M) machine-available vector; ``up``: optional
    (R, M) availability mask of a dynamic fleet (down machines have no
    room)."""
    in_batch = state.tasks.status == S.IN_BATCH
    room = state.mq_count < lcap
    if up is not None:
        room = room & up
    if avail is None:
        avail = S.machine_available(state, tables)
    eet_nm, energy_nm = const if const is not None else \
        expected_tables(state, tables)
    head = torch.where(in_batch.any(1),
                       torch.argmax(in_batch.to(torch.uint8), dim=1),
                       -1).to(torch.int32)
    return SchedView(in_batch, room, avail, eet_nm, energy_nm, head,
                     room.any(1), tables.rank)


def _pick_machine(view: SchedView, scores: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(R,) argmin of each replica's scores over its masked machines,
    first index on ties; -1 where no machine has room."""
    m, _ = K.masked_argmin(scores[:, None, :], mask[:, None, :])
    return torch.where(view.any_room, m, -1).to(torch.int32)


def _head_decision(view: SchedView, task: torch.Tensor,
                   machine: torch.Tensor) -> Decision:
    """Gate a (task, machine) pick on a task existing and a machine
    having room."""
    ok = (task >= 0) & view.any_room
    minus = torch.full_like(task, -1)
    return Decision(torch.where(ok, task, minus).to(torch.int32),
                    torch.where(ok, machine, minus).to(torch.int32),
                    torch.zeros_like(ok))


# --------------------------------------------------------------------------
# Immediate policies: each returns (task (R,), scores (R, M), mask (R, M));
# task is -1 where the replica has nothing to schedule.
# --------------------------------------------------------------------------
def fcfs(state, view: SchedView):
    return view.head, view.avail, view.room


def met(state, view: SchedView):
    scores = torch.where((view.head >= 0)[:, None],
                         view.row(view.eet_nm, view.head), BIG)
    return view.head, scores, view.room


def mct(state, view: SchedView):
    scores = torch.where((view.head >= 0)[:, None],
                         view.completion_row(view.head), BIG)
    return view.head, scores, view.room


def ee_met(state, view: SchedView):
    scores = torch.where((view.head >= 0)[:, None],
                         view.row(view.energy_nm, view.head),
                         BIG)
    return view.head, scores, view.room


def ee_mct(state, view: SchedView):
    """Min energy among deadline-feasible machines, else min completion.
    The scores fold the room mask in, so the argmin mask is all True."""
    h = view.head.clamp(min=0).long()
    dl = state.tasks.deadline.gather(1, h[:, None])
    crow = view.completion_row(h)
    feasible = (crow <= dl) & view.room
    energy = torch.where(feasible, view.row(view.energy_nm, h), BIG)
    fallback = torch.where(view.room, crow, BIG)
    scores = torch.where(feasible.any(1, keepdim=True), energy, fallback)
    return view.head, scores, torch.ones_like(view.room)


def edf_mct(state, view: SchedView):
    dl = torch.where(view.in_batch, state.tasks.deadline, BIG)
    t = torch.argmin(dl, dim=1).to(torch.int32)
    return (torch.where(view.in_batch.any(1), t, -1).to(torch.int32),
            view.completion_row(t), view.room)


def heft(state, view: SchedView):
    """Highest upward rank first (zeros on independent workloads, where
    it degenerates to head-of-queue), min expected completion machine."""
    score = torch.where(view.in_batch, view.rank, -BIG)
    t = torch.argmax(score, dim=1).to(torch.int32)
    return (torch.where(view.in_batch.any(1), t, -1).to(torch.int32),
            view.completion_row(t), view.room)


IMMEDIATE = {"fcfs": fcfs, "met": met, "mct": mct, "ee_met": ee_met,
             "ee_mct": ee_mct, "edf_mct": edf_mct, "heft": heft}


# --------------------------------------------------------------------------
# Policies that decide whole (task, machine) pairs
# --------------------------------------------------------------------------
def round_robin(state, view: SchedView) -> Decision:
    """First machine with room at or after ``rr_ptr`` (cyclic)."""
    n_m = view.room.shape[1]
    ids = torch.arange(n_m, device=view.room.device)
    order = (ids[None, :] + state.rr_ptr[:, None]) % n_m
    pick = torch.argmax(view.room.gather(1, order.long()).to(torch.uint8),
                        dim=1)
    m = order.gather(1, pick[:, None])[:, 0]
    return _head_decision(view, view.head, m)


def _pair_inputs(state, view: SchedView, rows: torch.Tensor | None):
    """The fused kernels' (avail, in_batch, room, type_id) of the
    replicas ``rows`` (None = all), and whether each has a valid
    (in_batch, room) pair."""
    def sel(x):
        return x if rows is None else x[rows]

    in_batch, room = sel(view.in_batch), sel(view.room)
    return (sel(view.avail), in_batch, room, sel(state.tasks.type_id)), \
        in_batch.any(1) & room.any(1)


def minmin(state, view: SchedView, rows: torch.Tensor | None,
           eet_m: torch.Tensor) -> Decision:
    """Classic Min-Min over the replicas ``rows`` (None = all): the
    (task, machine) pair of minimum expected completion.  The fused
    kernel builds the pairs on the fly from ``eet_m``, the speed-scaled
    (T, M) tables of those rows."""
    args, ok = _pair_inputs(state, view, rows)
    n_m = view.room.shape[1]
    flat, _ = K.fused_minmin(*args, eet_m)
    flat = flat.clamp(min=0)
    minus = torch.full_like(flat, -1)
    return Decision(torch.where(ok, flat // n_m, minus).to(torch.int32),
                    torch.where(ok, flat % n_m, minus).to(torch.int32),
                    torch.zeros_like(ok))


def maxmin(state, view: SchedView, rows: torch.Tensor | None,
           eet_m: torch.Tensor) -> Decision:
    """Classic Max-Min over the replicas ``rows`` (None = all): the task
    whose best expected completion is the worst, on its best machine."""
    args, ok = _pair_inputs(state, view, rows)
    t, m, _ = K.fused_maxmin(*args, eet_m)
    minus = torch.full_like(t, -1)
    return Decision(torch.where(ok, t, minus).to(torch.int32),
                    torch.where(ok, m, minus).to(torch.int32),
                    torch.zeros_like(ok))


PAIR_POLICIES = {"minmin": minmin, "maxmin": maxmin}


def scaled_eet_table(state: S.SimState, tables: S.StaticTables
                     ) -> torch.Tensor:
    """(R, T, M) speed-scaled EET table for the fused Min-Min and
    Max-Min kernels: elementwise the same division as the ``eet_nm``
    gather."""
    mach = state.machines
    r = torch.arange(mach.mtype.shape[0], device=mach.mtype.device)
    eet = tables.eet[r[:, None, None],
                     torch.arange(tables.eet.shape[1],
                                  device=r.device)[None, :, None],
                     mach.mtype.long()[:, None, :]]
    return eet / mach.speed[:, None, :]


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------
@dataclass
class Plan:
    """Which policies a batch runs, fixed for the whole run: per-replica
    selection masks, and for ``minmin``/``maxmin`` the replica rows that
    run them (None = every replica) with those rows' kernel tables."""
    names: tuple[str, ...]              # policies present
    is_policy: dict                     # name -> bool (R,)
    pair_rows: dict                     # name -> (R_p,) rows or None
    eet_m: dict                         # name -> (R_p, T, M) kernel table

    @classmethod
    def make(cls, policy_ids: torch.Tensor, state: S.SimState,
             tables: S.StaticTables) -> "Plan":
        present = sorted(set(policy_ids.tolist()))
        names = []
        for pid in present:
            if not 0 <= pid < len(POLICY_NAMES):
                raise ValueError(f"unknown policy id {pid}")
            name = POLICY_NAMES[pid]
            if name in NOT_PORTED:
                raise NotImplementedError(
                    f"policy {name!r}: {NOT_PORTED[name]}")
            names.append(name)
        is_policy = {n: policy_ids == POLICY_IDS[n] for n in names}
        pair = [name for name in PAIR_POLICIES if name in names]
        table = scaled_eet_table(state, tables) if pair else None
        pair_rows, eet_m = {}, {}
        for name in pair:
            rows = None if len(names) == 1 else \
                torch.nonzero(is_policy[name])[:, 0]
            pair_rows[name] = rows
            eet_m[name] = table if rows is None else table[rows]
        return cls(tuple(names), is_policy, pair_rows, eet_m)


def _cancel_wrap(dec: Decision, view: SchedView, state: S.SimState,
                 cancel_infeasible: bool) -> Decision:
    """Cancel the selected task when even its best machine cannot meet
    its deadline (E2C's "canceled tasks" pool)."""
    t = dec.task.clamp(min=0)
    best = torch.where(view.room, view.completion_row(t), BIG).amin(1)
    deadline = state.tasks.deadline.gather(1, t.long()[:, None])[:, 0]
    infeasible = best > deadline
    cancel = (dec.task >= 0) & infeasible & bool(cancel_infeasible)
    return Decision(dec.task, dec.machine, cancel)


def dispatch(plan: Plan, state: S.SimState, tables: S.StaticTables,
             lcap: int, cancel_infeasible: bool,
             const: tuple | None = None, *,
             avail: torch.Tensor | None = None,
             up: torch.Tensor | None = None) -> Decision:
    """Each replica's policy decision plus the cancellation wrapper;
    ``up`` is the (R, M) availability mask of a dynamic fleet."""
    view = build_view(state, tables, lcap, const, avail, up)
    r = view.head.shape[0]
    task = torch.full((r,), -1, dtype=torch.int32, device=view.head.device)
    machine = task.clone()

    imm = [n for n in plan.names if n in IMMEDIATE]
    if imm:
        t_sel = s_sel = m_sel = None
        for name in imm:
            t, s, mk = IMMEDIATE[name](state, view)
            if t_sel is None:
                t_sel, s_sel, m_sel = t, s, mk
            else:
                on = plan.is_policy[name]
                t_sel = torch.where(on, t, t_sel)
                s_sel = torch.where(on[:, None], s, s_sel)
                m_sel = torch.where(on[:, None], mk, m_sel)
        dec = _head_decision(view, t_sel, _pick_machine(view, s_sel, m_sel))
        task, machine = dec.task, dec.machine
    if "rr" in plan.names:
        dec = round_robin(state, view)
        on = plan.is_policy["rr"]
        task = torch.where(on, dec.task, task)
        machine = torch.where(on, dec.machine, machine)
    for name, rows in plan.pair_rows.items():
        dec = PAIR_POLICIES[name](state, view, rows, plan.eet_m[name])
        if rows is None:
            task, machine = dec.task, dec.machine
        else:
            task = task.index_copy(0, rows, dec.task)
            machine = machine.index_copy(0, rows, dec.machine)
    return _cancel_wrap(Decision(task, machine, torch.zeros_like(
        view.any_room)), view, state, cancel_infeasible)
