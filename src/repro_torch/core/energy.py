"""Energy accounting, batched over replicas.

The counterpart of ``repro.core.energy``: the engine accrues *active*
energy on each completion, drop or preemption; idle energy is integrated
here, every machine drawing ``P_idle * power_scale`` whenever it is not
executing, from t=0 until the replica's makespan.  A machine that is
down draws nothing, so with a ``MachineDynamics`` its downtime (clipped
to the makespan) leaves the idle integral.
"""
from __future__ import annotations

import torch

from repro_torch.core import state as S
from repro_torch.core.reduce import ordered_sum


def makespan(st: S.SimState) -> torch.Tensor:
    """(R,) time each replica went quiet: max terminal time (0 if none)."""
    span = st.tasks.t_end.amax(1)
    return torch.maximum(span, torch.zeros_like(span))


def downtime(dyn: S.MachineDynamics, span: torch.Tensor) -> torch.Tensor:
    """(R, M) seconds each machine spent down within [0, span] (span
    (R,))."""
    span = span[:, None, None]
    zero = torch.zeros_like(span)

    def clip(x):
        return torch.minimum(torch.maximum(x, zero), span)

    down = clip(dyn.down_end) - clip(dyn.down_start)
    return ordered_sum(torch.maximum(down, torch.zeros_like(down)), -1)


def availability(dyn: S.MachineDynamics, span: torch.Tensor
                 ) -> torch.Tensor:
    """(R, M) fraction of [0, span] each machine was available."""
    span = torch.maximum(span, torch.full((), 1e-9, dtype=span.dtype,
                                          device=span.device))
    return 1.0 - downtime(dyn, span) / span[:, None]


def mean_availability(avail: torch.Tensor) -> torch.Tensor:
    """(R,) mean of (R, M) availabilities over the machines; the
    reference's compiler divides by the constant M as a multiplication
    by its float32 reciprocal."""
    recip = torch.full((), 1.0 / avail.shape[1], dtype=torch.float32,
                       device=avail.device)
    return ordered_sum(avail, 1) * recip


def idle_energy(st: S.SimState, tables: S.StaticTables,
                dynamics: S.MachineDynamics | None = None) -> torch.Tensor:
    """(R, M) idle-power energy per machine up to the makespan (down
    machines are powered off and draw nothing)."""
    return idle_energy_until(st.machines, tables.power, makespan(st),
                             dynamics)


def idle_energy_until(mach: S.MachineState, power: torch.Tensor,
                      span: torch.Tensor,
                      dynamics: S.MachineDynamics | None = None
                      ) -> torch.Tensor:
    """(R, M) idle-power energy of the machines up to ``span`` (R,), for
    (R, Mt, 2) power tables; the streaming engine's span is its running
    maximum of terminal times."""
    idle_t = span[:, None] - mach.active_time
    idle_t = torch.maximum(idle_t, torch.zeros_like(idle_t))
    if dynamics is not None:
        idle_t = idle_t - downtime(dynamics, span)
        idle_t = torch.maximum(idle_t, torch.zeros_like(idle_t))
    rows = torch.arange(mach.mtype.shape[0], device=idle_t.device)[:, None]
    return power[rows, mach.mtype.long(), 0] * mach.power_scale * idle_t


def active_energy(st: S.SimState) -> torch.Tensor:
    """(R, M) active energy per machine (accrued by the engine)."""
    return st.machines.energy


def total_energy(st: S.SimState, tables: S.StaticTables,
                 dynamics: S.MachineDynamics | None = None) -> torch.Tensor:
    """(R,) total system energy in Joules."""
    return ordered_sum(active_energy(st) + idle_energy(st, tables, dynamics),
                       1)
