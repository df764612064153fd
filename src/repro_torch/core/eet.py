"""EET (expected execution time) tables: numpy generators.

A copy of the parts of ``repro.core.eet`` this port needs, kept here so
the port imports nothing of the JAX package.  ``eet[task_type,
machine_type]`` is the expected execution time of a task type on a
machine type; for the same seed every generator returns the same bits as
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class EETTable:
    eet: np.ndarray                     # (T_types, M_types) float32, seconds
    task_types: list[str] = field(default_factory=list)
    machine_types: list[str] = field(default_factory=list)

    def __post_init__(self):
        self.eet = np.asarray(self.eet, np.float32)
        t, m = self.eet.shape
        if not self.task_types:
            self.task_types = [f"t{i}" for i in range(t)]
        if not self.machine_types:
            self.machine_types = [f"m{j}" for j in range(m)]
        validate_eet(self.eet)

    @property
    def n_task_types(self) -> int:
        return self.eet.shape[0]

    @property
    def n_machine_types(self) -> int:
        return self.eet.shape[1]


def validate_eet(eet: np.ndarray) -> None:
    if eet.ndim != 2:
        raise ValueError(f"EET must be 2D (task_types x machine_types), "
                         f"got shape {eet.shape}")
    if not np.all(np.isfinite(eet)):
        raise ValueError("EET entries must be finite")
    if np.any(eet <= 0):
        raise ValueError("EET entries must be positive")


def synth_eet(n_task_types: int, n_machine_types: int, *,
              task_var: float = 1.0, machine_var: float = 0.5,
              inconsistency: float = 0.2, base: float = 1.0,
              seed: int = 0) -> EETTable:
    """CVB-style EET matrix: a rank-1 consistent core ``task_cost[i] *
    machine_slow[j]`` perturbed by lognormal inconsistency noise."""
    rng = np.random.default_rng(seed)
    task_cost = base * rng.lognormal(0.0, task_var, size=(n_task_types, 1))
    machine_slow = rng.lognormal(0.0, machine_var, size=(1, n_machine_types))
    noise = rng.lognormal(0.0, inconsistency,
                          size=(n_task_types, n_machine_types))
    return EETTable((task_cost * machine_slow * noise).astype(np.float32))


def default_power(n_machine_types: int, *, idle: float = 10.0,
                  active_lo: float = 40.0, active_hi: float = 220.0,
                  seed: int = 0) -> np.ndarray:
    """(M_types, 2) [idle_W, active_W] — faster machines burn more power."""
    rng = np.random.default_rng(seed)
    active = np.sort(rng.uniform(active_lo, active_hi, n_machine_types))
    idle_w = np.full(n_machine_types, idle)
    return np.stack([idle_w, active], axis=1).astype(np.float32)
