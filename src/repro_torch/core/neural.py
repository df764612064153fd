"""Parameterized (learned) scheduling policies, batched over replicas.

The counterpart of ``repro.core.neural``: two learned policies with the
reference's policy ids,

* ``linear``  score(machine) = w . features(head task, machine)
* ``mlp``     score(machine) = MLP(features(head task, machine)), one
              ReLU hidden layer of ``HIDDEN`` units.

Both are *immediate* policies: they score every machine for the FIFO
head of the batch queue, and ``schedulers.dispatch`` maps the head to
the lowest score among the machines with room (first index on ties), in
the same ``masked_argmin`` launch as the other immediate policies.

The ``N_FEATURES`` features of each (head task, machine) pair are the
reference's, normalized by the head task's mean EET ``s``:

  0  eet / s                 4  feasible (slack >= 0)   8  ee score:
  1  (avail - time) / s      5  queue depth / 4            energy among
  2  (completion - time) / s 6  energy / (s * pbar)        feasible
  3  slack / s               7  1.0 (bias)                 machines with
                                                           room, else
                                                           completion

``PolicyParams`` holds both families' weights.  Each leaf has either no
leading axis (one set of weights for every replica) or a leading R axis
(one set per replica: an ES population evaluates as one sweep).

The forward pass is plain PyTorch with every sum in an explicit, fixed
association order, never ``torch.matmul``: a library product may use
TF32 or another order on the card.  The orders are those of XLA's CPU
dot on the reference's shapes, found by test
(``tests/test_torch_neural.py``): with weights shared by the replicas
(the reference's ``in_axes=None``) the hidden layer sums its nine terms
in four fused lanes ``k, k + 4`` and then ``((l0 + l1) + (l2 + l3)) +
p8``, the output layer and ``linear`` as one fused chain; with
per-replica weights (batched) the hidden layer is one fused chain, the
output layer eight fused lanes ``k, k + 8`` reduced by halving, and
``linear`` ``((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) + p8``.
Multiply-adds are fused as XLA fuses them, each one step of the
``kernels/fma.py`` wrapper: float32 ``x * w + acc`` rounded once, one
launch on the card (``__fmaf_rn``) and ``reduce.fma`` on the CPU, so the
card gives the CPU's bits and both the reference's.

``machine_features_np`` and ``score_machines_np`` are the reference's
numpy mirror, for ``core/ref_engine.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.reduce import ordered_sum
from repro_torch.kernels import fma as FMA

N_FEATURES = 9
HIDDEN = 16
_EPS = 1e-6
_INFEAS = 100.0     # f8 offset pushing feasible machines ahead
BIG = 1e30


class MLPParams(NamedTuple):
    w1: torch.Tensor    # f32 ([R,] N_FEATURES, HIDDEN)
    b1: torch.Tensor    # f32 ([R,] HIDDEN)
    w2: torch.Tensor    # f32 ([R,] HIDDEN)
    b2: torch.Tensor    # f32 ([R])


class LinearParams(NamedTuple):
    w: torch.Tensor     # f32 ([R,] N_FEATURES)


class PolicyParams(NamedTuple):
    """Both learned families' weights, shared by every replica (no
    leading axis) or one set per replica (a leading R axis on every
    leaf)."""
    mlp: MLPParams
    linear: LinearParams

    def to(self, device) -> "PolicyParams":
        return map_params(lambda x: x.to(device), self)


def map_params(fn, params: PolicyParams) -> PolicyParams:
    """``fn`` applied to every leaf."""
    return PolicyParams(MLPParams(*(fn(x) for x in params.mlp)),
                        LinearParams(*(fn(x) for x in params.linear)))


def stacked(params) -> bool:
    """Whether ``params`` (a ``PolicyParams`` or one family) carries a
    leading replica axis."""
    fam = params.mlp if isinstance(params, PolicyParams) else params
    return fam[0].dim() == (3 if isinstance(fam, MLPParams) else 2)


def _zeros(device) -> PolicyParams:
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return PolicyParams(MLPParams(z(N_FEATURES, HIDDEN), z(HIDDEN),
                                  z(HIDDEN), z()),
                        LinearParams(z(N_FEATURES)))


def default_params(device="cuda") -> PolicyParams:
    """All-zero weights: every machine scores 0.0, so both learned
    policies pick the first machine with room.  The engine substitutes
    them when the caller passes none."""
    return _zeros(device)


def init_params(seed: int = 0, scale: float = 0.3, *,
                generator: torch.Generator | None = None,
                device="cuda") -> PolicyParams:
    """Random init for training (small weights: near-uniform scores),
    drawn on the host from ``generator`` (default: a CPU generator
    seeded with ``seed``) and copied to ``device``, so the card and the
    CPU get the same numbers.  The reference's ``jax.random`` draws are
    not reproduced; carry its weights across with
    ``interop.policy_params_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    w1 = scale * normal(N_FEATURES, HIDDEN) / np.float32(np.sqrt(N_FEATURES))
    w2 = scale * normal(HIDDEN) / np.float32(np.sqrt(HIDDEN))
    lw = scale * normal(N_FEATURES)
    p = _zeros("cpu")
    return PolicyParams(p.mlp._replace(w1=w1, w2=w2),
                        LinearParams(lw)).to(dev)


def _unit_params(feature: int, device) -> PolicyParams:
    """One identity ReLU unit passing feature ``feature`` through (the
    MLP), and the linear weight on the same feature."""
    p = _zeros("cpu")
    w1 = p.mlp.w1.clone()
    w1[feature, 0] = 1.0
    w2 = p.mlp.w2.clone()
    w2[0] = 1.0
    lw = p.linear.w.clone()
    lw[feature] = 1.0
    return PolicyParams(p.mlp._replace(w1=w1, w2=w2),
                        LinearParams(lw)).to(resolve_device(device))


def mct_mlp_params(device="cuda") -> PolicyParams:
    """Weights that reproduce MCT exactly: feature 2 is a positive
    monotone transform of MCT's score and nonnegative, so one identity
    ReLU unit passes it through."""
    return _unit_params(2, device)


def ee_mlp_params(device="cuda") -> PolicyParams:
    """Weights that reproduce ``ee_mct`` exactly (feature 8 is its
    ranking, nonnegative): the training warm start."""
    return _unit_params(8, device)


def n_trainable(policy: str) -> int:
    """Flat parameter count of one learned family (177 for ``mlp``, 9
    for ``linear``)."""
    return sum(x.numel() for x in getattr(_zeros("cpu"), policy))


# --------------------------------------------------------------------------
# Features and the forward pass
# --------------------------------------------------------------------------
def features(eet_row: torch.Tensor, en_row: torch.Tensor,
             avail: torch.Tensor, time: torch.Tensor,
             deadline: torch.Tensor, mq_count: torch.Tensor,
             room: torch.Tensor) -> torch.Tensor:
    """(B, M, N_FEATURES) features of mapping each row's head task to
    each machine: ``eet_row``, ``en_row``, ``avail`` (B, M) f32,
    ``time`` and the head's ``deadline`` (B,), ``mq_count`` (B, M) and
    ``room`` (B, M) bool."""
    m = eet_row.shape[-1]
    eps = torch.full_like(time, _EPS)
    # jnp.mean divides by M, which XLA rewrites as a multiplication by
    # the float32 reciprocal and fuses with ``+ _EPS`` into one
    # multiply-add (found by test); so does this, on both devices
    inv_m = torch.full_like(time, np.float32(1.0) / np.float32(m))
    t = time[:, None]
    wait = avail - t
    completion = avail + eet_row - t
    slack = deadline[:, None] - (avail + eet_row)
    s = FMA.fma(ordered_sum(eet_row, 1), inv_m, eps)[:, None]
    pbar = FMA.fma(ordered_sum(en_row / (eet_row + eps[:, None]), 1),
                   inv_m, eps)[:, None]
    en_n = en_row / (s * pbar)
    comp_n = completion / s
    feasible = slack >= 0
    feas_room = feasible & room
    ee = torch.where(feas_room.any(1, keepdim=True),
                     torch.where(feas_room, en_n, en_n + _INFEAS), comp_n)
    # the queue depth's division by 4 is exact as a multiplication
    return torch.stack([
        eet_row / s, wait / s, comp_n, slack / s,
        feasible.to(torch.float32), mq_count.to(torch.float32) * 0.25,
        en_n, torch.ones_like(eet_row), ee], dim=-1)


def head_features(state, view, rows: torch.Tensor | None = None,
                  head: torch.Tensor | None = None) -> torch.Tensor:
    """(B, M, N_FEATURES) features of the replicas ``rows`` (None = all)
    for their task ``head`` (default: the view's FIFO head; -1 reads task
    0, whose scores the policy masks).  ``state`` is a
    ``state.SimState``, ``view`` a ``schedulers.SchedView``."""
    def sel(x):
        return x if rows is None else x[rows]

    head = sel(view.head) if head is None else head
    h = head.clamp(min=0).long()
    r = torch.arange(h.shape[0], device=h.device) if rows is None else rows
    return features(view.eet_nm[r, h], view.energy_nm[r, h],
                    sel(view.avail), sel(state.time),
                    state.tasks.deadline[r, h], sel(state.mq_count),
                    sel(view.room))


def _w(w: torch.Tensor, batched: bool, k) -> torch.Tensor:
    """Row ``k`` of a weight matrix, broadcastable against (B, M, ...)."""
    return w[:, None, k] if batched else w[k]


def _x(x: torch.Tensor, k) -> torch.Tensor:
    return x[..., k, None]


def _halve(lanes: list) -> torch.Tensor:
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + h] for i in range(h)]
    return lanes[0]


def _chain(x: torch.Tensor, w: torch.Tensor, batched: bool
           ) -> torch.Tensor:
    """sum_k x[k] w[k] as one fused chain: p0, then a multiply-add for
    k = 1, ..."""
    acc = _x(x, 0) * _w(w, batched, 0)
    for k in range(1, x.shape[-1]):
        acc = FMA.fma(_x(x, k), _w(w, batched, k), acc)
    return acc


def mlp_scores(params: MLPParams, feats: torch.Tensor) -> torch.Tensor:
    """(B, M) scores, lower = better machine; ``params`` shared or with
    a leading B axis."""
    b = stacked(params)
    w1, b1, w2, b2 = params
    if b:
        z = _chain(feats, w1, True)
    else:
        # four lanes l = k, k + 4, reduced pairwise, then term 8
        lanes = FMA.fma(feats[..., 4:8, None], w1[4:8],
                        feats[..., 0:4, None] * w1[0:4])
        z = (lanes[..., 0, :] + lanes[..., 1, :]) \
            + (lanes[..., 2, :] + lanes[..., 3, :])
        z = z + _x(feats, 8) * w1[8]
    hid = torch.maximum(z + (b1[:, None] if b else b1), torch.zeros_like(z))
    if b:
        # eight lanes l = k, k + 8, reduced by halving
        w = w2[:, None, :]
        lanes = FMA.fma(hid[..., 8:16], w[..., 8:16],
                        hid[..., 0:8] * w[..., 0:8])
        out = _halve([lanes[..., i] for i in range(8)])
        return out + b2[:, None]
    return _chain(hid, w2[:, None], False)[..., 0] + b2


def linear_scores(params: LinearParams, feats: torch.Tensor
                  ) -> torch.Tensor:
    """(B, M) scores ``feats . w``; ``params`` shared or batched."""
    w = params.w
    if stacked(params):
        p = feats * w[:, None, :]
        return _halve([p[..., i] for i in range(8)]) + p[..., 8]
    return _chain(feats, w[:, None], False)[..., 0]


def scores(policy: str, params: PolicyParams, feats: torch.Tensor
           ) -> torch.Tensor:
    """(B, M) scores of learned policy ``policy``."""
    if policy == "mlp":
        return mlp_scores(params.mlp, feats)
    return linear_scores(params.linear, feats)


# --------------------------------------------------------------------------
# numpy mirror (core/ref_engine.py)
# --------------------------------------------------------------------------
def params_to_numpy(params: PolicyParams | None) -> dict:
    """Host float32 copy of the weights (``w1, b1, w2, b2, lw``), the
    reference's ``params_to_numpy`` layout."""
    if params is None:
        params = _zeros("cpu")

    def f(x):
        return np.asarray(x.detach().cpu().numpy(), np.float32)

    return {"w1": f(params.mlp.w1), "b1": f(params.mlp.b1),
            "w2": f(params.mlp.w2), "b2": f(params.mlp.b2),
            "lw": f(params.linear.w)}


def machine_features_np(eet_row, en_row, avail, time, deadline,
                        mq_count, room) -> np.ndarray:
    """numpy mirror of the features (float32, the reference's op
    order); ``room`` is the (M,) "queue has space and machine is up"
    mask."""
    eet_row = np.asarray(eet_row, np.float32)
    en_row = np.asarray(en_row, np.float32)
    avail = np.asarray(avail, np.float32)
    room = np.asarray(room, bool)
    time = np.float32(time)
    deadline = np.float32(deadline)
    wait = avail - time
    completion = avail + eet_row - time
    slack = deadline - (avail + eet_row)
    s = np.float32(np.mean(eet_row) + np.float32(_EPS))
    pbar = np.float32(np.mean(en_row / (eet_row + np.float32(_EPS)))
                      + np.float32(_EPS))
    en_n = en_row / (s * pbar)
    comp_n = completion / s
    feas_room = (slack >= 0) & room
    ee = np.where(feas_room.any(),
                  np.where(feas_room, en_n, en_n + np.float32(_INFEAS)),
                  comp_n)
    return np.stack([
        eet_row / s, wait / s, comp_n, slack / s,
        (slack >= 0).astype(np.float32),
        np.asarray(mq_count, np.float32) / np.float32(4.0),
        en_n, np.ones_like(eet_row), ee], axis=1).astype(np.float32)


def score_machines_np(params_np: dict, feats: np.ndarray,
                      kind: str) -> np.ndarray:
    """(M,) scores from the numpy weights; mirrors the forward pass."""
    feats = np.asarray(feats, np.float32)
    if kind == "linear":
        return feats @ params_np["lw"]
    hid = np.maximum(feats @ params_np["w1"] + params_np["b1"],
                     np.float32(0.0))
    return hid @ params_np["w2"] + params_np["b2"]


# --------------------------------------------------------------------------
# The policies (the immediate form of schedulers.register_policy)
# --------------------------------------------------------------------------
def _policy(name: str, state, view, params: PolicyParams,
            rows: torch.Tensor | None = None):
    s = scores(name, params, head_features(state, view, rows))
    head = view.head if rows is None else view.head[rows]
    room = view.room if rows is None else view.room[rows]
    return head, torch.where((head >= 0)[:, None], s, BIG), room


def mlp_policy(state, view, params: PolicyParams,
               rows: torch.Tensor | None = None):
    """``(task, scores, room)`` of the replicas ``rows`` (None = all):
    the FIFO head, its MLP scores (``BIG`` where the queue is empty) and
    the room mask, for the shared masked argmin."""
    return _policy("mlp", state, view, params, rows)


def linear_policy(state, view, params: PolicyParams,
                  rows: torch.Tensor | None = None):
    """As :func:`mlp_policy`, with the linear scores."""
    return _policy("linear", state, view, params, rows)


LEARNED_POLICIES = ("mlp", "linear")
POLICIES = {"mlp": mlp_policy, "linear": linear_policy}
