"""Energy accounting for a static fleet, batched over replicas.

The counterpart of ``repro.core.energy``: the engine accrues *active*
energy on each completion or drop; idle energy is integrated here, every
machine drawing ``P_idle * power_scale`` whenever it is not executing,
from t=0 until the replica's makespan.
"""
from __future__ import annotations

import torch

from repro_torch.core import state as S
from repro_torch.core.reduce import ordered_sum


def makespan(st: S.SimState) -> torch.Tensor:
    """(R,) time each replica went quiet: max terminal time (0 if none)."""
    span = st.tasks.t_end.amax(1)
    return torch.maximum(span, torch.zeros_like(span))


def idle_energy(st: S.SimState, tables: S.StaticTables) -> torch.Tensor:
    """(R, M) idle-power energy per machine up to the makespan."""
    mach = st.machines
    idle_t = makespan(st)[:, None] - mach.active_time
    idle_t = torch.maximum(idle_t, torch.zeros_like(idle_t))
    rows = torch.arange(mach.mtype.shape[0], device=idle_t.device)[:, None]
    return tables.power[rows, mach.mtype.long(), 0] * mach.power_scale \
        * idle_t


def active_energy(st: S.SimState) -> torch.Tensor:
    """(R, M) active energy per machine (accrued by the engine)."""
    return st.machines.energy


def total_energy(st: S.SimState, tables: S.StaticTables) -> torch.Tensor:
    """(R,) total system energy in Joules."""
    return ordered_sum(active_energy(st) + idle_energy(st, tables), 1)
