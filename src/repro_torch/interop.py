"""Carry replica inputs across from the JAX package, as numpy arrays.

``replicas_from_numpy`` turns the reference's stacked inputs — a task
table, the machine types, the static tables (HEFT ranks included), the
policy ids, for a dynamic fleet the machine dynamics and for workflows
the parent tables, each with a leading replica axis — into the port's
tensors, so both engines compute on the same data;
``dynamics_from_numpy`` converts the dynamics alone;
``lm_params_from_numpy`` turns a language model's parameter tree into the
port's parameters, ``policy_params_from_numpy`` the learned policies'
weights into ``neural.PolicyParams``.  All read their inputs through
``numpy.asarray``, attribute and key access only, so they import nothing
of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import neural as NN
from repro_torch.core import state as S
from repro_torch.core.workload import task_table
from repro_torch.launch.experiment import Replicas
from repro_torch.models.model import encoder_layout, layout


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
                        parents=None, device="cuda") -> Replicas:
    """``tasks``: anything with ``arrival``/``type_id``/``deadline``
    (R, N) columns; ``tables``: anything with ``eet`` (R, T, Mt),
    ``power`` (R, Mt, 2), ``noise`` (R, N) and ``rank`` (R, N);
    ``mtype`` (R, M); ``policy_ids`` (R,); ``dynamics`` None or what
    ``dynamics_from_numpy`` takes; ``parents`` None or (R, N, K) parent
    tables padded with -1.  Arrays of any kind that ``numpy.asarray``
    reads."""
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
        None if dynamics is None else dynamics_from_numpy(dynamics, dev),
        None if parents is None else put(parents, np.int32, torch.int32))


def lm_params_from_numpy(tree, cfg, device="cuda") -> dict:
    """The reference's ``init_params`` tree (dicts and lists with array
    leaves of any kind ``numpy.asarray`` reads; each cycle slot's
    parameters stacked on a leading layer axis for ``lax.scan``) as the
    port's parameters (``models/model.py``: the same keys, each cycle
    slot a list over cycles), on ``device`` in f32.  Every leaf comes
    across, the encoder stack of an encoder-decoder model unstacked like
    the decoder's."""
    dev = resolve_device(device)

    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, index) for v in node]
        a = np.asarray(node, np.float32)
        if index is not None:
            a = a[index]
        return torch.as_tensor(a.copy(), device=dev)

    def unstack(stack, n_cycles):
        return {"prefix": conv(stack["prefix"]),
                "cycle": [[conv(slot, c) for c in range(n_cycles)]
                          for slot in stack["cycle"]],
                "suffix": conv(stack["suffix"])}

    stacks = {"stack": layout(cfg).n_cycles}
    if "encoder" in tree:
        stacks["encoder"] = encoder_layout(cfg).n_cycles
    return {k: unstack(v, stacks[k]) if k in stacks else conv(v)
            for k, v in tree.items()}


def policy_params_from_numpy(d: dict, device="cuda"):
    """The reference's ``neural.params_to_numpy`` dict (``w1, b1, w2,
    b2, lw``, each with an optional leading replica axis) as the port's
    ``neural.PolicyParams`` on ``device`` in f32: how the tests carry the
    reference's weights across."""
    dev = resolve_device(device)

    def put(key):
        return torch.as_tensor(np.array(d[key], np.float32, copy=True),
                               device=dev)

    return NN.PolicyParams(NN.MLPParams(put("w1"), put("b1"), put("w2"),
                                        put("b2")),
                           NN.LinearParams(put("lw")))
