"""Workload generation: numpy arrival draws, handed to torch at the end.

A copy of the parts of ``repro.core.workload`` this slice needs (the
Poisson generator and the task-table conversion).  For the same seed the
arrays are bit-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.state import TaskTable


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
