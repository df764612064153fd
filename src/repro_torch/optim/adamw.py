"""AdamW with mixed precision: the single-device half of
``repro/optim/adamw.py``.

The compute params are in the model's dtype (bf16 on the card, f32 in
the CPU tests); the optimizer keeps an f32 master copy and the two
moments, 12 bytes a parameter.  The reference's order of operations is
kept: the global-norm clip scale, ``skip_nonfinite`` (a non-finite norm
zeroes the gradient, holds the step count and the master, and the
moments decay), the bias corrections ``1 - b**t`` in f32 at the
incremented step, and decoupled weight decay on the master.  Unlike the
reference's pure update, ``adamw_update`` updates the state's master
and moments in place (6 GB each of f32 for a 1.5B model) and returns
the same tensors in a new ``OptState``; the returned compute params are
fresh copies.  Every scalar stays on the device: an update reads nothing
back to the host.  ``opt_state_specs`` (the ZeRO-1 layout) waits for the
distributed slice (ROADMAP queue A, item 11.6).

A tree is a nest of dicts (visited in sorted-key order, as ``jax.tree``
does) and lists with tensor leaves: the port's parameter trees.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4               # peak; multiplied by the schedule value
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0         # global-norm clip; 0 disables
    skip_nonfinite: bool = True    # skip the update if grads are inf/nan


class OptState(NamedTuple):
    step: torch.Tensor     # i32 ()
    master: Any            # f32 param copy
    m: Any                 # first moment (f32)
    v: Any                 # second moment (f32)


def tree_leaves(tree) -> list:
    """The tensor leaves of a tree, dicts in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``,
    in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def adamw_init(params) -> OptState:
    """Step 0, the master an f32 copy of ``params`` (never an alias) and
    zero moments, on the params' device."""
    leaf = tree_leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        master=tree_map(lambda x: x.to(torch.float32, copy=True), params),
        m=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params),
        v=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt: OptState, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0,
                 compute_dtype=torch.bfloat16):
    """-> (new params in ``compute_dtype``, new opt state, metrics
    ``{grad_norm, update_skipped}``).  ``opt``'s master and moments are
    updated in place."""
    gnorm = global_norm(grads)
    finite = torch.isfinite(gnorm)
    scale = torch.where((cfg.grad_clip > 0) & (gnorm > cfg.grad_clip),
                        cfg.grad_clip / torch.clamp(gnorm, min=1e-12), 1.0)
    ok = finite | (not cfg.skip_nonfinite)
    step = opt.step + ok.to(torch.int32)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    for g, mast, m, v in zip(tree_leaves(grads), tree_leaves(opt.master),
                             tree_leaves(opt.m), tree_leaves(opt.v)):
        g = torch.where(ok, g.to(torch.float32) * scale, 0.0)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * mast
        mast.sub_(lr * torch.where(ok, delta, 0.0))
    params = tree_map(lambda x: x.to(compute_dtype, copy=True), opt.master)
    new_opt = OptState(step=step, master=opt.master, m=opt.m, v=opt.v)
    metrics = {"grad_norm": gnorm,
               "update_skipped": (~ok).to(torch.int32)}
    return params, new_opt, metrics
