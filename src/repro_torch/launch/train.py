"""The training step on one device: the single-device half of
``repro/launch/train.py``.

    init_train_state(cfg, mopts, device, seed) -> (params, opt_state)
    build_train_step(cfg, mopts, ocfg, scfg, device)
        -> train_step(params, opt_state, batch)
           -> (params, opt_state, metrics)

The reference's ``build_train_step`` (:102) and ``init_train_state``
(:303) on a one-device mesh.  ``batch`` holds ``tokens``/``labels``
(and a frontend's ``frames`` or ``patch_embeds``) as numpy arrays or
tensors, e.g. ``data.TokenStream.batch_at(step)``; they are moved to the
device.  The gradient is ``torch.autograd.grad`` of ``models.model.
loss_fn`` with respect to every parameter leaf; with ``microbatches`` =
n > 1, microbatch j takes rows j, j + n, j + 2n, ... of the batch (the
reference's reshape to (b / n, n, ...) and swap of the first two axes),
the gradients accumulate in an f32 buffer and are divided by n, and the
loss and ce are the microbatches' means; with n = 1 the gradients stay
in the params' dtype.  The update is ``optim.adamw_update`` at the
``warmup_cosine`` scale of the state's step (0 at step 0), returning
params in ``compute_dtype`` from the f32 master.  The metrics are
``loss``, ``ce``, ``lr_scale``, ``grad_norm`` and ``update_skipped``,
0-dim tensors on the device: a step reads nothing back to the host.

The partition specs, ``build_train_artifacts``, int8 gradient
compression, ``TrainLoop`` and checkpoints wait for later slices
(ROADMAP queue A, items 11.5 and 11.6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, warmup_cosine)
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    compute_dtype: Any = torch.bfloat16
    warmup_steps: int = 100
    decay_steps: int = 10000


def batch_to(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (integers as int32 or
    int64 as given, floats as they are)."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


def build_train_step(cfg: ArchConfig, mopts: ModelOptions,
                     ocfg: AdamWConfig, scfg: TrainStepConfig,
                     device="cuda") -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    opt state's master and moments are updated in place."""
    dev = resolve_device(device)
    mb_n = scfg.microbatches

    def grads_of(params, batch):
        tree = tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = tree_leaves(tree)
        if mb_n == 1:
            loss, mets = M.loss_fn(tree, batch, cfg, mopts)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), mets["ce"].detach(), grads
        b = next(iter(batch.values())).shape[0]
        if b % mb_n:
            raise ValueError(f"batch {b} is not divisible into {mb_n} "
                             f"microbatches")
        acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for x in leaves]
        losses, ces = [], []
        for j in range(mb_n):
            mb = {k: v[j::mb_n] for k, v in batch.items()}
            loss, mets = M.loss_fn(tree, mb, cfg, mopts)
            for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                a.add_(g)
            losses.append(loss.detach())
            ces.append(mets["ce"].detach())
        for a in acc:
            a.div_(mb_n)
        return torch.stack(losses).mean(), torch.stack(ces).mean(), acc

    def train_step(params, opt_state: OptState, batch: dict):
        loss, ce, flat = grads_of(params, batch_to(batch, dev))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        lr_scale = warmup_cosine(opt_state.step,
                                 warmup_steps=scfg.warmup_steps,
                                 decay_steps=scfg.decay_steps)
        params, new_opt, om = adamw_update(grads, opt_state, ocfg, lr_scale,
                                           compute_dtype=scfg.compute_dtype)
        metrics = {"loss": loss, "ce": ce, "lr_scale": lr_scale, **om}
        return params, new_opt, metrics

    return train_step


def init_train_state(cfg: ArchConfig, mopts: ModelOptions, device="cuda",
                     seed: int = 0):
    """-> (params in ``mopts.dtype``, ``adamw_init`` of them): weights
    drawn on the device from ``seed``, so the master is the cast params
    in f32, as in the reference."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    params = tree_map(lambda x: x.to(mopts.dtype),
                      M.init_params(gen, cfg))
    return params, adamw_init(params)
