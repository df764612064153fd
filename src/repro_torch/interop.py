"""Carry replica inputs across from the JAX package, as numpy arrays.

``replicas_from_numpy`` turns the reference's stacked inputs — a task
table, the machine types, the static tables, the policy ids and, for a
dynamic fleet, the machine dynamics, each with a leading replica axis —
into the port's tensors, so both engines compute on the same data;
``dynamics_from_numpy`` converts the dynamics alone.  Both read their
inputs through ``numpy.asarray`` and attribute access only, so they
import nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import state as S
from repro_torch.core.workload import task_table
from repro_torch.launch.experiment import Replicas


def dynamics_from_numpy(dynamics, device="cuda") -> S.MachineDynamics:
    """``dynamics``: anything with ``speed``/``power_scale`` (R, M),
    ``down_start``/``down_end`` (R, M, K) and ``kill`` (R, M)."""
    dev = resolve_device(device)

    def put(x, np_dtype):
        return torch.as_tensor(np.array(x, np_dtype, copy=True), device=dev)

    return S.MachineDynamics(
        speed=put(dynamics.speed, np.float32),
        power_scale=put(dynamics.power_scale, np.float32),
        down_start=put(dynamics.down_start, np.float32),
        down_end=put(dynamics.down_end, np.float32),
        kill=put(dynamics.kill, bool))


def replicas_from_numpy(tasks, mtype, tables, policy_ids, dynamics=None,
                        device="cuda") -> Replicas:
    """``tasks``: anything with ``arrival``/``type_id``/``deadline``
    (R, N) columns; ``tables``: anything with ``eet`` (R, T, Mt),
    ``power`` (R, Mt, 2), ``noise`` (R, N) and ``rank`` (R, N);
    ``mtype`` (R, M); ``policy_ids`` (R,); ``dynamics`` None or what
    ``dynamics_from_numpy`` takes.  Arrays of any kind that
    ``numpy.asarray`` reads."""
    dev = resolve_device(device)

    def put(x, np_dtype, dtype):
        return torch.as_tensor(np.array(x, np_dtype, copy=True),
                               dtype=dtype, device=dev)

    def f32(x):
        return put(x, np.float32, torch.float32)

    return Replicas(
        task_table(np.array(tasks.arrival, np.float32),
                   np.array(tasks.type_id, np.int32),
                   np.array(tasks.deadline, np.float32), device=dev),
        put(mtype, np.int32, torch.int32),
        S.StaticTables(eet=f32(tables.eet), power=f32(tables.power),
                       noise=f32(tables.noise), rank=f32(tables.rank)),
        put(policy_ids, np.int32, torch.int32),
        None if dynamics is None else dynamics_from_numpy(dynamics, dev))
