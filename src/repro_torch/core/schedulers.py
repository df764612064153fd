"""Scheduling policies, batched over replicas.

The counterpart of ``repro.core.schedulers``: the ten heuristics
``fcfs, rr, met, mct, ee_met, ee_mct, minmin, maxmin, edf_mct, heft``
with the reference's policy ids, the cancellation wrapper and
``dispatch``, and the learned ``mlp``/``linear`` policies
(``core/neural.py``) with the weights that ``Plan.make`` keeps for their
rows.  Down machines of a dynamic fleet have no ``room``, so every
policy is failure-aware through the view.

The reference evaluates one replica at a time and picks the policy with
``lax.switch``.  Here one call decides for all R replicas at once, each
with its own policy.  The immediate policies (every one but ``rr`` and
``minmin``, the learned ones included) share a shape — pick a task,
score the machines, take the masked argmin — so each returns its task
and (R, M) score and mask rows,
``dispatch`` selects the rows by policy id and reduces them with ONE
``masked_argmin`` for the whole batch; ``minmin`` and ``maxmin`` run
their fused kernels on the replicas that use them.  Every replica's
decision is the one its
``lax.switch`` branch takes.

``dispatch_k`` makes up to K sequential drain decisions in one call, as
the reference's K-way drain does: the head, deadline and rank ordered
policies construct them exactly with a K-step scan over (R, M) rows, and
``rr``, ``minmin``, ``maxmin`` and the learned policies speculate K tasks
under the frozen view and keep the longest prefix that the sequential
drain would also take.
Each policy runs on its own replica rows, as in ``dispatch``: the
reference's ``lax.switch`` over every branch is not paid.

``register_policy(name, fn)`` plugs in a user policy (the paper's
feature (ii)) with the next id.  It takes the immediate form ``(state,
view) -> (task (R,), scores (R, M), mask (R, M))``, so that its machine
pick joins the one ``masked_argmin`` launch of ``dispatch``, or returns
a ``Decision``; ``dispatch_k`` speculates it in FIFO order and keeps a
prefix only past cancels, as the reference does for user policies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch.core import neural as NN
from repro_torch.core import state as S
from repro_torch.kernels import sched_argmin as K

BIG = 1e30
INF = float("inf")

POLICY_NAMES = ["fcfs", "rr", "met", "mct", "ee_met", "ee_mct", "minmin",
                "maxmin", "edf_mct", "heft", "mlp", "linear"]
POLICY_IDS = {name: i for i, name in enumerate(POLICY_NAMES)}
BUILTIN = frozenset(POLICY_NAMES)


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


#: the ported policies by name, then the registered ones
SCHEDULERS = {"rr": round_robin, **IMMEDIATE, **PAIR_POLICIES}


def register_policy(name: str, fn) -> int:
    """Plug in a user policy under the next policy id and return the id.
    ``fn(state, view)`` returns ``(task (R,), scores (R, M), mask (R,
    M))``, the task -1 where a replica has nothing to schedule and the
    machine the first masked argmin of the scores, or a ``Decision``;
    either way the cancellation wrapper applies.  Raises ``ValueError``
    for a name already taken, built-ins included."""
    if name in POLICY_IDS:
        raise ValueError(f"policy {name!r} already registered")
    SCHEDULERS[name] = fn
    POLICY_NAMES.append(name)
    POLICY_IDS[name] = len(POLICY_NAMES) - 1
    return POLICY_IDS[name]


def _user(name: str) -> bool:
    return name not in BUILTIN


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
    selection masks, the replica rows of each policy (None = every
    replica), for ``minmin``/``maxmin`` those rows' kernel tables and for
    the learned policies those rows' weights."""
    names: tuple[str, ...]              # policies present
    is_policy: dict                     # name -> bool (R,)
    pair_rows: dict                     # name -> (R_p,) rows or None
    eet_m: dict                         # name -> (R_p, T, M) kernel table
    rows: dict                          # name -> (R_p,) rows or None,
    #                                     for every policy present
    learned: dict = field(default_factory=dict)  # name -> the rows'
    #                                     neural.PolicyParams
    eet_mk: dict = field(default_factory=dict)  # (name, k) -> the kernel
    #                                     table (or the learned weights)
    #                                     repeated for k views

    @classmethod
    def make(cls, policy_ids: torch.Tensor, state: S.SimState,
             tables: S.StaticTables,
             policy_params: NN.PolicyParams | None = None) -> "Plan":
        """``policy_params``: the learned policies' weights, shared (no
        leading axis) or one set per replica (leading R axis); None =
        ``neural.default_params()``."""
        present = sorted(set(policy_ids.tolist()))
        names = []
        for pid in present:
            if not 0 <= pid < len(POLICY_NAMES):
                raise ValueError(f"unknown policy id {pid}")
            names.append(POLICY_NAMES[pid])
        is_policy = {n: policy_ids == POLICY_IDS[n] for n in names}
        rows = {n: None if len(names) == 1 else
                torch.nonzero(is_policy[n])[:, 0] for n in names}
        pair = [name for name in PAIR_POLICIES if name in names]
        table = scaled_eet_table(state, tables) if pair else None
        pair_rows, eet_m = {}, {}
        for name in pair:
            pair_rows[name] = rows[name]
            eet_m[name] = table if rows[name] is None else table[rows[name]]
        learned = {}
        learned_names = [n for n in NN.LEARNED_POLICIES if n in names]
        if learned_names:
            dev = policy_ids.device
            pp = NN.default_params(dev) if policy_params is None \
                else policy_params.to(dev)
            per_replica = NN.stacked(pp)
            if per_replica and pp.mlp.w1.shape[0] != policy_ids.shape[0]:
                raise ValueError(f"policy_params carry {pp.mlp.w1.shape[0]}"
                                 f" replicas, the run {policy_ids.shape[0]}")
            for name in learned_names:
                learned[name] = pp if rows[name] is None or not per_replica \
                    else NN.map_params(lambda x, r=rows[name]: x[r], pp)
        return cls(tuple(names), is_policy, pair_rows, eet_m, rows, learned)


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

    imm, decided = [], []          # imm: (name, rows, (task, scores, mask))
    for name in plan.names:
        if name in plan.learned:
            # the learned rows' scores, computed on those rows alone
            imm.append((name, plan.rows[name], NN.POLICIES[name](
                state, view, plan.learned[name], plan.rows[name])))
        elif name in IMMEDIATE or _user(name):
            out = SCHEDULERS[name](state, view)
            if isinstance(out, Decision):
                decided.append((name, out))
            else:
                imm.append((name, None, out))
    if imm:
        t_sel = s_sel = m_sel = None
        for name, rows, (t, s, mk) in imm:
            if rows is None and t_sel is None:
                t_sel, s_sel, m_sel = t, s, mk
                continue
            if t_sel is None:
                t_sel = torch.full_like(view.head, -1)
                s_sel = torch.full_like(view.avail, BIG)
                m_sel = view.room
            if rows is None:
                on = plan.is_policy[name]
                t_sel = torch.where(on, t, t_sel)
                s_sel = torch.where(on[:, None], s, s_sel)
                m_sel = torch.where(on[:, None], mk, m_sel)
            else:
                t_sel = t_sel.index_copy(0, rows, t)
                s_sel = s_sel.index_copy(0, rows, s)
                m_sel = m_sel.index_copy(0, rows, mk)
        dec = _head_decision(view, t_sel, _pick_machine(view, s_sel, m_sel))
        task, machine = dec.task, dec.machine
    for name, dec in decided:
        on = plan.is_policy[name]
        task = torch.where(on, dec.task, task).to(torch.int32)
        machine = torch.where(on, dec.machine, machine).to(torch.int32)
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


# --------------------------------------------------------------------------
# K-way dispatch: up to K sequential drain decisions in one call
# --------------------------------------------------------------------------
# Policies whose j-th sequential decision is a closed form of (avail,
# queue counts) after the first j-1: a static task order (FIFO, deadline,
# upward rank; ties to the lowest id) and the policy's own machine rule.
# A K-step scan constructs their K decisions exactly.
_SCAN_RULES: dict[str, tuple[str, str]] = {
    # policy -> (task-order key, machine scoring rule)
    "fcfs": ("head", "avail"),
    "met": ("head", "eet"),
    "mct": ("head", "mct"),
    "ee_met": ("head", "energy"),
    "ee_mct": ("head", "ee_mct"),
    "edf_mct": ("edf", "mct"),
    "heft": ("rank", "mct"),
}

# The other policies speculate their task order under the frozen view
# (FIFO, or each task's best frozen completion, ascending for Min-Min and
# descending for Max-Min) and validate a sequentially consistent prefix.
_SPEC_ORDER: dict[str, str] = {"rr": "head", "minmin": "minmin",
                               "maxmin": "maxmin"}   # learned and user
#                                                      policies: head

# Min-Min's choice provably survives the prefix corrections (all prefix
# machines distinct: the winner's cell is untouched, every other
# corrected cell only grows or loses its room).  ``rr`` (its pointer
# moves with each map), ``maxmin`` (its argmax over growing row minima
# can flip) and the learned and user policies (opaque scores) extend
# their prefix only past cancels.
_SPECULATIVE_SAFE = {"minmin"}


def _order_by_key(keys: torch.Tensor, valid: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """(R, k) first k task ids of each row by (key, id), -1 padded: a
    stable sort, so ties keep the lowest id, as the sequential
    first-index argmin does.  The reference's sort treats -0.0 and +0.0
    as equal; so does this one, which turns -0.0 into +0.0 first, so
    that the CPU's comparison sort and the card's radix sort agree."""
    masked = torch.where(valid, keys, INF)
    masked = torch.where(masked == 0, 0.0, masked)
    order = torch.argsort(masked, dim=1, stable=True)[:, :k]
    order = torch.where(valid.gather(1, order), order, -1).to(torch.int32)
    if order.shape[1] < k:                   # fewer tasks than the width
        order = torch.nn.functional.pad(order, (0, k - order.shape[1]),
                                        value=-1)
    return order


def _first_k(valid: torch.Tensor, k: int) -> torch.Tensor:
    """(R, k) the first k valid task ids of each row, -1 padded: the
    order ``_order_by_key`` gives task ids, without a sort."""
    r, n = valid.shape
    pos = torch.cumsum(valid.to(torch.int32), 1, dtype=torch.int32) - 1
    col = torch.where(valid & (pos < k), pos, k).long()
    ids = torch.arange(n, dtype=torch.int32, device=valid.device)
    out = torch.full((r, k + 1), -1, dtype=torch.int32, device=valid.device)
    out.scatter_(1, col, ids.expand(r, n))
    return out[:, :k].contiguous()


def _gather_rows(table: torch.Tensor, rows: torch.Tensor | None,
                 t: torch.Tensor) -> torch.Tensor:
    """``table[rows[i], t[i, j]]`` for an (R, N, ...) table and (R_p, k)
    task ids (clamped at 0); all rows where ``rows`` is None."""
    r = torch.arange(t.shape[0], device=t.device) if rows is None else rows
    return table[r[:, None], t.clamp(min=0).long()]


def _scan_k(plan: Plan, state: S.SimState, view: SchedView, lcap: int,
            cancel_infeasible: bool, k: int, up: torch.Tensor | None):
    """The K sequential decisions of every replica whose policy is in
    ``_SCAN_RULES``, constructed by a K-step scan that carries (avail,
    per-machine map counts): the same float adds in the same order as
    the sequential drain and one ``masked_argmin`` over (R, 1, M) rows a
    step.  Returns (task, machine, cancel) (R, k), the prefix mask and the
    carried avail; rows of other policies are overwritten by the
    caller."""
    names = [n for n in plan.names if n in _SCAN_RULES]
    tasks = state.tasks
    # task order: FIFO for every row, then the deadline and rank orders
    # on the rows of the policies that use them
    order = _first_k(view.in_batch, k)
    for kind in ("edf", "rank"):
        kind_names = [n for n in names if _SCAN_RULES[n][0] == kind]
        if not kind_names:
            continue
        rows = None if plan.rows[kind_names[0]] is None else torch.cat(
            [plan.rows[n] for n in kind_names])
        sel = (lambda x: x) if rows is None else (lambda x: x[rows])
        key = tasks.deadline if kind == "edf" else -view.rank
        o = _order_by_key(sel(key), sel(view.in_batch), k)
        order = o if rows is None else order.index_copy(0, rows, o)
    eet_k = _gather_rows(view.eet_nm, None, order)              # (R, k, M)
    energy_k = _gather_rows(view.energy_nm, None, order)
    dl_k = tasks.deadline.gather(1, order.clamp(min=0).long())  # (R, k)
    rules = {}
    for n in names:
        rule = _SCAN_RULES[n][1]
        rules[rule] = plan.is_policy[n] if rule not in rules \
            else rules[rule] | plan.is_policy[n]
    n_m = view.room.shape[1]
    ids = torch.arange(n_m, device=order.device)
    avail = view.avail
    cnt = torch.zeros_like(state.mq_count)
    out_t, out_m, out_c = [], [], []
    for j in range(k):
        t, eet_row, energy_row, dl = order[:, j], eet_k[:, j], \
            energy_k[:, j], dl_k[:, j]
        room = (state.mq_count + cnt) < lcap
        if up is not None:
            room = room & up
        any_room = room.any(1)
        crow = avail + eet_row                      # completion_row(t)
        s_sel = m_sel = None
        for rule, on in rules.items():
            if rule == "ee_mct":
                feasible = (crow <= dl[:, None]) & room
                energy = torch.where(feasible, energy_row, BIG)
                fallback = torch.where(room, crow, BIG)
                scores = torch.where(feasible.any(1, keepdim=True), energy,
                                     fallback)
                mask = torch.ones_like(room)
            else:
                scores = {"avail": avail, "eet": eet_row,
                          "energy": energy_row, "mct": crow}[rule]
                mask = room
            if s_sel is None:
                s_sel, m_sel = scores, mask
            else:
                s_sel = torch.where(on[:, None], scores, s_sel)
                m_sel = torch.where(on[:, None], mask, m_sel)
        m, _ = K.masked_argmin(s_sel[:, None, :], m_sel[:, None, :])
        m = torch.where(any_room, m, -1)
        ok = (t >= 0) & any_room
        task = torch.where(ok, t, -1).to(torch.int32)
        mach = torch.where(ok, m, -1).to(torch.int32)
        best = torch.where(room, crow, BIG).amin(1)   # the cancel wrapper
        cancel = (task >= 0) & (best > dl) & bool(cancel_infeasible)
        mapped = (task >= 0) & ~cancel
        m_oh = (ids == mach[:, None]) & mapped[:, None]
        avail = torch.where(m_oh, avail + eet_row, avail)
        cnt = cnt + m_oh.to(torch.int32)
        out_t.append(task)
        out_m.append(mach)
        out_c.append(cancel)
    task = torch.stack(out_t, 1)
    # the queue and the room only shrink within a trip, so the first
    # no-op is final
    use = torch.cumsum((task < 0).to(torch.int32), 1) == 0
    return (task, torch.stack(out_m, 1), torch.stack(out_c, 1)), use, avail


def _speculate_k(name: str, plan: Plan, state: S.SimState,
                 view: SchedView, lcap: int, cancel_infeasible: bool,
                 k: int, up: torch.Tensor | None):
    """One speculative K-trip of the replicas of ``name`` (``rr``,
    ``minmin``, ``maxmin`` or a user policy): speculate K tasks under the
    frozen view, decide all K views (view j without the j earlier
    speculated tasks) in one batched call, then keep the longest
    sequentially consistent prefix: the dispatched task is the
    speculated one, its machine differs from every earlier mapped
    machine, the cancel verdict holds under the corrected avail and
    room, and for policies outside ``_SPECULATIVE_SAFE`` every earlier
    candidate was a cancel.
    Candidate 0 is the true decision, so a trip applies at least one.
    Returns (task, machine, cancel), the prefix mask and the avail after
    the prefix, for the rows ``plan.rows[name]``."""
    rows = plan.rows[name]
    tasks = state.tasks

    def sel(x):
        return x if rows is None else x[rows]

    in_batch, room, avail = sel(view.in_batch), sel(view.room), \
        sel(view.avail)
    any_room, mq_count = sel(view.any_room), sel(state.mq_count)
    r, n = in_batch.shape
    n_m = room.shape[1]
    dev = in_batch.device
    kind = _SPEC_ORDER.get(name, "head")
    if kind == "head":
        spec = _first_k(in_batch, k)
    else:
        # each task's best frozen completion: it depends only on the
        # task's type, so reduce the (R_p, T, M) table and gather
        best_t = torch.where(room[:, None, :],
                             avail[:, None, :] + plan.eet_m[name],
                             BIG).amin(2)
        best = best_t.gather(1, sel(tasks.type_id).long())
        spec = _order_by_key(best if kind == "minmin" else -best,
                             in_batch & any_room[:, None], k)

    # view j: the queue without speculated tasks 0..j-1
    steps = torch.arange(k, dtype=torch.int32, device=dev)
    pos = torch.full((r, n + 1), k, dtype=torch.int32, device=dev)
    pos.scatter_(1, torch.where(spec >= 0, spec, n).long(),
                 steps.expand(r, k))
    in_batch_k = in_batch[:, None, :] & (pos[:, None, :n]
                                         >= steps[None, :, None])
    any_k = in_batch_k.any(2)                                   # (R_p, k)
    if name in plan.learned:
        task, mach = _learned_k(name, plan, state, view, k, spec)
    elif _user(name):
        task, mach = (sel(x) for x in _user_k(name, state, view, k))
    elif name == "rr":
        order = (torch.arange(n_m, device=dev)[None, :]
                 + sel(state.rr_ptr)[:, None]) % n_m
        pick = torch.argmax(room.gather(1, order.long()).to(torch.uint8), 1)
        m = order.gather(1, pick[:, None])                      # (R_p, 1)
        head_k = torch.where(any_k, torch.argmax(
            in_batch_k.to(torch.uint8), 2), -1)
        ok = (head_k >= 0) & any_room[:, None]
        task = torch.where(ok, head_k, -1).to(torch.int32)
        mach = torch.where(ok, m, -1).to(torch.int32)
    else:
        key = (name, k)
        if key not in plan.eet_mk:
            plan.eet_mk[key] = plan.eet_m[name].repeat_interleave(
                k, 0).contiguous()

        def rep(x):
            return x.repeat_interleave(k, 0)

        args = (rep(avail), in_batch_k.reshape(r * k, n), rep(room),
                rep(sel(tasks.type_id)), plan.eet_mk[key])
        ok = any_k & any_room[:, None]
        if name == "minmin":
            flat, _ = K.fused_minmin(*args)
            flat = flat.view(r, k).clamp(min=0)
            t, m = flat // n_m, flat % n_m
        else:
            t, m, _ = K.fused_maxmin(*args)
            t, m = t.view(r, k), m.view(r, k)
        task = torch.where(ok, t, -1).to(torch.int32)
        mach = torch.where(ok, m, -1).to(torch.int32)
    # the cancel wrapper of each view (frozen avail and room)
    eet_t = _gather_rows(view.eet_nm, rows, task)               # (R_p, k, M)
    dl = sel(tasks.deadline).gather(1, task.clamp(min=0).long())
    best = torch.where(room[:, None, :], avail[:, None, :] + eet_t,
                       BIG).amin(2)
    ci = bool(cancel_infeasible)
    cancel = (task >= 0) & (best > dl) & ci

    # prefix corrections: per-machine map counts and expected-time adds
    # of the earlier mapped candidates; with the prefix's machines
    # distinct, each corrected machine takes one exact add
    nonneg = task >= 0
    mapped = nonneg & ~cancel
    ids = torch.arange(n_m, device=dev)
    moh = (mach.clamp(0, n_m - 1)[:, :, None] == ids) & mapped[:, :, None]
    cnt = torch.cumsum(moh.to(torch.int32), 1, dtype=torch.int32) \
        - moh.to(torch.int32)
    add = torch.where(moh, eet_t, 0.0)
    cum = torch.cumsum(add, 1) - add
    avail_k = torch.where(cnt > 0, avail[:, None, :] + cum,
                          avail[:, None, :])
    room_k = (mq_count[:, None, :] + cnt) < lcap
    if up is not None:
        room_k = room_k & sel(up)[:, None, :]
    conflict = nonneg & (cnt.gather(2, mach.clamp(0, n_m - 1).long()[
        :, :, None])[:, :, 0] > 0)
    best_k = torch.where(room_k, avail_k + eet_t, BIG).amin(2)
    cancel_ok = (nonneg & ci & (best_k > dl)) == cancel
    ok = nonneg & (task == spec) & ~conflict & cancel_ok
    if name not in _SPECULATIVE_SAFE:
        prior = torch.cumsum(mapped.to(torch.int32), 1) \
            - mapped.to(torch.int32)
        ok = ok & (prior == 0)
    ok[:, 0] = True                       # candidate 0 is the true decision
    use = (torch.cumsum((~ok).to(torch.int32), 1) == 0) & nonneg
    moh_used = moh & use[:, :, None]
    addv = torch.where(moh_used, eet_t, 0.0).sum(1)
    avail_after = torch.where(moh_used.any(1), avail + addv, avail)
    return (task, mach, cancel), use, avail_after


def _learned_k(name: str, plan: Plan, state: S.SimState, view: SchedView,
               k: int, first: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R_p, k) task and machine of learned policy ``name`` on its rows
    in each of the k views: view j's FIFO head is ``first[:, j]``, the
    j-th queued task; avail, room and queue depths are the frozen view's.
    The k views' features and scores are computed at once over R_p k
    rows, each replica's weights repeated for its k views, and the
    machine picks are one ``masked_argmin`` over (R_p k, 1, M) rows."""
    rows = plan.rows[name]
    r_p = first.shape[0]
    if rows is None:
        rows = torch.arange(r_p, device=first.device)
    rep = rows.repeat_interleave(k)
    head = first.reshape(-1)
    feats = NN.head_features(state, view, rep, head)
    params = plan.learned[name]
    if NN.stacked(params):
        key = (name, k)
        if key not in plan.eet_mk:
            plan.eet_mk[key] = NN.map_params(
                lambda x: x.repeat_interleave(k, 0), params)
        params = plan.eet_mk[key]
    scores = torch.where((head >= 0)[:, None],
                         NN.scores(name, params, feats), BIG)
    room = view.room[rep]
    m, _ = K.masked_argmin(scores[:, None, :], room[:, None, :])
    ok = (first >= 0) & view.any_room[rows][:, None]
    return (torch.where(ok, first, -1).to(torch.int32),
            torch.where(ok, m.view(r_p, k), -1).to(torch.int32))


def _user_k(name: str, state: S.SimState, view: SchedView, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, k) task and machine of user policy ``name`` in each of the k
    views (view j: the queue without its j first tasks), for every
    replica; the immediate form's machine picks of all k views in one
    ``masked_argmin`` over (R k, 1, M) rows."""
    r, n = view.in_batch.shape
    n_m = view.room.shape[1]
    first = _first_k(view.in_batch, k)
    steps = torch.arange(k, dtype=torch.int32, device=first.device)
    pos = torch.full((r, n + 1), k, dtype=torch.int32, device=first.device)
    pos.scatter_(1, torch.where(first >= 0, first, n).long(),
                 steps.expand(r, k))
    outs = []
    for j in range(k):
        in_batch = view.in_batch & (pos[:, :n] >= j)
        head = torch.where(in_batch.any(1), torch.argmax(
            in_batch.to(torch.uint8), dim=1), -1).to(torch.int32)
        outs.append(SCHEDULERS[name](state, view._replace(
            in_batch=in_batch, head=head)))
    if isinstance(outs[0], Decision):
        return (torch.stack([o.task for o in outs], 1).to(torch.int32),
                torch.stack([o.machine for o in outs], 1).to(torch.int32))
    t = torch.stack([o[0] for o in outs], 1)
    scores = torch.stack([o[1] for o in outs], 1).reshape(r * k, 1, n_m)
    mask = torch.stack([o[2] for o in outs], 1).reshape(r * k, 1, n_m)
    m, _ = K.masked_argmin(scores, mask)
    ok = (t >= 0) & view.any_room[:, None]
    return (torch.where(ok, t, -1).to(torch.int32),
            torch.where(ok, m.view(r, k), -1).to(torch.int32))


def dispatch_k(plan: Plan, state: S.SimState, tables: S.StaticTables,
               lcap: int, cancel_infeasible: bool, k: int,
               const: tuple | None = None, *,
               avail: torch.Tensor | None = None,
               up: torch.Tensor | None = None
               ) -> tuple[Decision, torch.Tensor, torch.Tensor]:
    """One K-way drain trip: up to ``k`` sequential decisions of every
    replica.  Returns the (R, k) ``Decision``, the (R, k) mask of the
    prefix to apply (``engine._apply_decisions_k``) and the (R, M)
    machine-available vector after that prefix; bitwise the sequential
    drain's decisions and carry."""
    view = build_view(state, tables, lcap, const, avail, up)
    r = view.head.shape[0]
    dev = view.head.device
    task = torch.full((r, k), -1, dtype=torch.int32, device=dev)
    mach = task.clone()
    cancel = torch.zeros((r, k), dtype=torch.bool, device=dev)
    use = cancel.clone()
    av = view.avail
    if any(n in _SCAN_RULES for n in plan.names):
        (task, mach, cancel), use, av = _scan_k(
            plan, state, view, lcap, cancel_infeasible, k, up)
    for name in plan.names:
        if name in _SCAN_RULES:
            continue
        (t, m, c), u, a = _speculate_k(name, plan, state, view, lcap,
                                       cancel_infeasible, k, up)
        rows = plan.rows[name]
        if rows is None:
            task, mach, cancel, use, av = t, m, c, u, a
        else:
            task = task.index_copy(0, rows, t)
            mach = mach.index_copy(0, rows, m)
            cancel = cancel.index_copy(0, rows, c)
            use = use.index_copy(0, rows, u)
            av = av.index_copy(0, rows, a)
    return Decision(task, mach, cancel), use, av
