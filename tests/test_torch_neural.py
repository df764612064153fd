"""The port's learned policies (``core/neural.py``) against the JAX
package's.

The same numpy inputs go through ``repro.core.neural`` and
``repro_torch.core.neural``, the reference's weights carried across with
``interop.policy_params_from_numpy``.  Tolerances:

* features: 0 (bitwise) on flat and dynamic-fleet views;
* scores: the reference's scores are XLA's CPU dot, whose association
  order changes with the shapes; the port sums in one fixed order (the
  one XLA uses on the engine's shapes, ``core/neural.py``), so each
  score is held to ``1e-6 * sum_k |x_k w_k|`` (the magnitude of its
  terms: a reordered f32 sum of nine or sixteen terms errs by less);
* final states: 0 on every state field, for ``mlp`` and ``linear`` with
  random per-replica weights (pseeds 0, 3, 7) on flat, failure, spot +
  DVFS and workflow instances, the trace rows too, and the K-way drain
  at K = 2 and 8 (the reference's K-way schedule is bitwise its
  one-decision schedule, so both are held to it; K = 8 also to the
  reference's own K = 8 executable);
* warm starts and the oracle: 0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_drain_kway import (FIELDS, assert_bitwise, mixed_batch,
                                   port_run)
from test_torch_trace import assert_trace_equal

from repro.core import engine as E
from repro.core import neural as JN
from repro.core import ref_engine as R
from repro.core import schedulers as JP
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import neural as NN
from repro_torch.core import ref_engine as TR
from repro_torch.core import schedulers as TP
from repro_torch.core import train_policy as TTP
from repro_torch.kernels import ref as KR

pytestmark = pytest.mark.torch

PSEEDS = (0, 3, 7)


def port_params(pp):
    return interop.policy_params_from_numpy(JN.params_to_numpy(pp), "cpu")


def _view_inputs(seed, r, n, m, dynamic):
    """Random view arrays of r replicas; ``dynamic``: DVFS-scaled
    expected times and down machines without room."""
    rng = np.random.default_rng(seed)
    eet = rng.uniform(0.5, 9.0, (r, n, m)).astype(np.float32)
    if dynamic:
        speed = rng.choice(np.float32([0.5, 0.75, 1.0, 1.2]), (r, 1, m))
        eet = (eet / speed).astype(np.float32)
    energy = (eet * rng.uniform(50, 300, (r, 1, m))).astype(np.float32)
    time = rng.uniform(0, 5, r).astype(np.float32)
    avail = np.maximum(rng.uniform(0, 20, (r, m)), time[:, None]).astype(
        np.float32)
    deadline = rng.uniform(5, 40, (r, n)).astype(np.float32)
    mq = rng.integers(0, 5, (r, m)).astype(np.int32)
    room = mq < 4
    if dynamic:
        room &= rng.random((r, m)) < 0.7
    head = rng.integers(-1, n, r).astype(np.int32)
    return eet, energy, avail, time, deadline, mq, room, head


def _jax_features(eet, energy, avail, time, deadline, mq, room, head):
    class St:
        pass

    def one(eet, energy, avail, time, deadline, mq, room, head):
        st = St()
        st.time, st.mq_count = time, mq
        st.tasks = St()
        st.tasks.deadline = deadline
        view = JP.SchedView(jnp.zeros(eet.shape[0], bool), room, avail, eet,
                            energy, head, room.any(), jnp.zeros(eet.shape[0]))
        return JN.machine_features(st, view)

    return np.asarray(jax.jit(jax.vmap(one))(
        eet, energy, avail, time, deadline, mq, room, head))


def _port_features(eet, energy, avail, time, deadline, mq, room, head):
    class V:
        pass

    t = torch.from_numpy
    view = TP.SchedView(None, t(room), t(avail), t(eet), t(energy),
                        t(head), t(room).any(1), None)
    st = V()
    st.time, st.mq_count = t(time), t(mq)
    st.tasks = V()
    st.tasks.deadline = t(deadline)
    return NN.head_features(st, view).numpy()


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("r,n,m", [(16, 10, 3), (24, 12, 5), (32, 8, 8),
                                   (8, 6, 32)])
def test_features_bitwise(r, n, m, dynamic):
    args = _view_inputs(r * m, r, n, m, dynamic)
    want = _jax_features(*args)
    got = _port_features(*args)
    assert got.shape == (r, m, NN.N_FEATURES)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("policy", NN.LEARNED_POLICIES)
@pytest.mark.parametrize("r,m", [(4, 3), (16, 5), (64, 8), (8, 32)])
def test_scores_match(policy, stacked, r, m):
    rng = np.random.default_rng(r + m)
    feats = rng.normal(0, 2, (r, m, NN.N_FEATURES)).astype(np.float32)
    pops = [JN.init_params(s) for s in range(r)]
    pp = jax.tree.map(lambda *x: jnp.stack(x), *pops) if stacked \
        else pops[1]

    def fwd(p, f):
        return JN.mlp_scores(p.mlp, f) if policy == "mlp" \
            else JN.linear_scores(p.linear, f)

    want = np.asarray(jax.jit(jax.vmap(
        fwd, in_axes=(0 if stacked else None, 0)))(pp, feats))
    got = NN.scores(policy, port_params(pp), torch.from_numpy(feats)).numpy()
    d = JN.params_to_numpy(pp)
    f = np.abs(feats.astype(np.float64))
    if stacked:
        w1, b1, w2, b2, lw = (np.abs(d[k]).astype(np.float64)
                              for k in ("w1", "b1", "w2", "b2", "lw"))
        if policy == "mlp":
            mag = np.einsum("rmh,rh->rm", np.einsum("rmk,rkh->rmh", f, w1)
                            + b1[:, None], w2) + b2[:, None]
        else:
            mag = np.einsum("rmk,rk->rm", f, lw)
    else:
        a = {k: np.abs(v).astype(np.float64) for k, v in d.items()}
        mag = ((f @ a["w1"] + a["b1"]) @ a["w2"] + a["b2"]
               if policy == "mlp" else f @ a["lw"])
    assert got.shape == want.shape == (r, m)
    assert (np.abs(got.astype(np.float64) - want) <= 1e-6 * mag).all()


# The queue C probe: x * w rounds to a float32 midpoint above acc, so
# a multiply-add rounded twice (float64 sum, then float32) gives
# 0x1.000004p+0 where a fused one gives 0x1.000002p+0.
PROBE_X = np.float32(2**-12 * (1 + 2**-18))
PROBE_W = np.float32(2**-12 * (1 - 2**-18))
PROBE_ACC = np.float32(1 + 2**-23)


def _probe(policy, stacked, layer, r, m):
    """Features and numpy weights that put the probe into one
    multiply-add of the forward pass: the chain of ``linear``, the
    hidden layer's first lane (shared: lane k = 0, 4; batched: the
    chain's k = 1) or the output layer's (shared: the chain's k = 1;
    batched: lane k = 0, 8); every other weight 0."""
    f = np.zeros((r, m, NN.N_FEATURES), np.float32)
    d = {k: np.zeros_like(v)
         for k, v in JN.params_to_numpy(JN.init_params(0)).items()}
    if policy == "linear":
        f[..., 0], f[..., 1] = PROBE_ACC, PROBE_X
        d["lw"][0], d["lw"][1] = 1, PROBE_W
    elif layer == "hidden":
        k = 1 if stacked else 4
        f[..., 0], f[..., k] = PROBE_ACC, PROBE_X
        d["w1"][0, :], d["w1"][k, :] = 1, PROBE_W
        d["w2"][0] = 1
    else:
        k = 8 if stacked else 1
        d["b1"][0], d["b1"][k] = PROBE_ACC, PROBE_X
        d["w2"][0], d["w2"][k] = 1, PROBE_W
    if stacked:
        d = {k: np.broadcast_to(v, (r,) + v.shape).copy()
             for k, v in d.items()}
    return f, d


@pytest.mark.parametrize("r,m", [(4, 3), (64, 8), (8, 32), (4096, 32)])
@pytest.mark.parametrize("policy,stacked,layer", [
    ("linear", False, "chain"), ("linear", True, "chain"),
    ("mlp", False, "hidden"), ("mlp", False, "output"),
    ("mlp", True, "hidden"), ("mlp", True, "output")])
def test_queue_c_probe_bitwise(policy, stacked, layer, r, m):
    """Every multiply-add of the forward pass rounds once, as XLA's
    fused one does: bitwise the jitted JAX forward pass on the probe,
    shared and batched weights, at the engine's shapes."""
    f, d = _probe(policy, stacked, layer, r, m)
    pp = JN.PolicyParams(
        JN.MLPParams(*(jnp.asarray(d[k]) for k in ("w1", "b1", "w2", "b2"))),
        JN.LinearParams(jnp.asarray(d["lw"])))

    def fwd(p, x):
        return JN.mlp_scores(p.mlp, x) if policy == "mlp" \
            else JN.linear_scores(p.linear, x)

    want = np.asarray(jax.jit(jax.vmap(
        fwd, in_axes=(0 if stacked else None, 0)))(pp, f))
    got = NN.scores(policy, interop.policy_params_from_numpy(d, "cpu"),
                    torch.from_numpy(f)).numpy()
    assert got.shape == want.shape == (r, m)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # fused: x * w is below half an ulp of acc; the batched linear form
    # rounds the product first, which ties up to 1 + 2^-22
    assert want[0, 0] == (np.float32(1 + 2**-22) if policy == "linear"
                          and stacked else PROBE_ACC)


def test_fma_wrapper_cpu_is_reduce_fma():
    """On CPU tensors the kernel's wrapper is its plain version,
    ``reduce.fma``, over broadcast operands, counting no launch; it
    refuses other dtypes and mixed devices."""
    from repro_torch.core.reduce import fma as reduce_fma
    from repro_torch.kernels import fma as FMA
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 1, 3, 1), generator=g)
    w = torch.randn((3, 7), generator=g)
    acc = torch.randn((5, 2, 1, 7), generator=g)
    before = dict(FMA.launches)
    got = FMA.fma(x, w, acc)
    assert got.shape == (5, 2, 3, 7) and FMA.launches == before
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  reduce_fma(x, w, acc).numpy()
                                  .view(np.int32))
    np.testing.assert_array_equal(
        FMA.fma(torch.tensor([PROBE_X]), torch.tensor([PROBE_W]),
                torch.tensor([PROBE_ACC])).numpy(), [PROBE_ACC])
    with pytest.raises(ValueError, match="float32"):
        FMA.fma(x.double(), w, acc)
    # the kernel's geometry: the shape padded to four axes, each
    # operand's strides broadcast (0 on broadcast axes)
    g = FMA.geometry(torch.Size([5, 2, 3]), x[..., 0], w[:, 0],
                     acc[..., 0])
    assert (g.n, list(g.shape)) == (5 * 2 * 3, [1, 5, 2, 3])
    assert list(g.sx) == [0, 3, 0, 1] and list(g.sw) == [0, 0, 0, 7] \
        and list(g.sa) == [0, 14, 7, 0]


def test_fma_refuses_offsets_past_32_bits():
    """The kernel indexes in 32 bits: the wrapper's check passes the
    forward pass's largest layouts and refuses an element count or an
    operand offset past ``MAX_INDEX`` (broadcast views, no memory)."""
    from repro_torch.kernels import fma as FMA
    one = torch.zeros(1)
    for shape in ((4096, 32, 4, 16), (4096, 32, 64), (8192, 1024)):
        s = torch.Size(shape)
        FMA.check_fits(FMA.geometry(s, one.expand(s), one, one))
    s = torch.Size([2**16, 2**16])
    with pytest.raises(ValueError, match="32-bit"):
        FMA.check_fits(FMA.geometry(s, one.expand(2**16, 1),
                                    one.expand(1, 2**16), one))
    # two elements, but an operand strided past the limit (a meta
    # tensor: strides without storage)
    s = torch.Size([2, 1])
    far = torch.empty_strided((2, 1), (FMA.MAX_INDEX + 1, 1),
                              device="meta")
    with pytest.raises(ValueError, match="offset"):
        FMA.check_fits(FMA.geometry(s, far, one, one))


def test_parameter_helpers():
    """The warm starts, ``n_trainable``, the ravel order (that of the
    reference's ``ravel_pytree``) and the numpy round trip."""
    from jax.flatten_util import ravel_pytree
    for make in ("default_params", "mct_mlp_params", "ee_mlp_params"):
        want = JN.params_to_numpy(getattr(JN, make)())
        got = NN.params_to_numpy(getattr(NN, make)("cpu"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=make)
    for fam in NN.LEARNED_POLICIES:
        assert NN.n_trainable(fam) == JN.n_trainable(fam)
        pp = JN.init_params(4)
        theta, unravel = TTP.ravel(getattr(port_params(pp), fam))
        np.testing.assert_array_equal(
            theta.numpy(), np.asarray(ravel_pytree(getattr(pp, fam))[0]))
        back = unravel(torch.stack([theta, theta * 2]))
        assert NN.stacked(back) and back[0].shape[0] == 2
    assert NN.n_trainable("mlp") == 177 and NN.n_trainable("linear") == 9
    a, b = NN.init_params(3, device="cpu"), NN.init_params(3, device="cpu")
    for x, y in zip(a.mlp + a.linear, b.mlp + b.linear):
        assert torch.equal(x, y)
    gen = torch.Generator().manual_seed(3)
    c = NN.init_params(generator=gen, device="cpu")
    assert torch.equal(c.mlp.w1, a.mlp.w1)


# --------------------------------------------------------------------------
# Final states against the JAX engine
# --------------------------------------------------------------------------
def learned_batch():
    """``mixed_batch``'s five instances (flat, fail/repair, spot + DVFS,
    two workflows) under ``mlp`` and ``linear``, each with the random
    weights of pseeds 0, 3 and 7 per replica; returns (batch, stacked
    JAX weights)."""
    base = mixed_batch()
    per_inst = len(base[3]) // 5
    rows, pps = [], []
    for inst in range(5):
        for name in NN.LEARNED_POLICIES:
            for ps in PSEEDS:
                rows.append(inst * per_inst)
                pps.append((name, JN.init_params(ps)))
    idx = np.asarray(rows)
    batch = jax.tree.map(lambda x: x[idx], base)
    pids = jnp.asarray([JP.POLICY_IDS[n] for n, _ in pps], jnp.int32)
    pp = jax.tree.map(lambda *x: jnp.stack(x), *[p for _, p in pps])
    return batch[:3] + (pids,) + batch[4:], pp


def jax_learned(batch, pp, params):
    return E.run_sweep(*batch[:4], params, batch[4], pp, batch[5])


def port_learned(batch, pp, params, stats=None):
    reps = interop.replicas_from_numpy(*batch, device="cpu")
    return TE.run_sweep(reps.tasks, reps.mtype, reps.tables, reps.policy_ids,
                        params, stats, reps.dynamics, reps.parents,
                        port_params(pp))


@pytest.fixture(scope="module")
def learned():
    batch, pp = learned_batch()
    want = jax_learned(batch, pp, E.SimParams(lcap=3, trace=True))
    got = port_learned(batch, pp, TE.SimParams(lcap=3, trace=True))
    return batch, pp, want, got


def test_learned_run_sweep_bitwise(learned):
    batch, _, want, got = learned
    assert_bitwise(want, got, "learned, per-replica weights")
    assert (got.tasks.status.numpy() >= 4).all()
    assert len(np.unique(got.tasks.machine.numpy(), axis=0)) > 10


def test_learned_trace_rows_bitwise(learned):
    _, _, want, got = learned
    assert_trace_equal(want, got, range(got.tasks.status.shape[0]),
                       "learned trace")


@pytest.mark.parametrize("k", [2, 8])
def test_learned_kway_bitwise(learned, k):
    batch, pp, want, _ = learned
    got = port_learned(batch, pp, TE.SimParams(lcap=3, drain_k=k))
    assert_bitwise(want, got, f"learned drain_k={k}", FIELDS)


def test_learned_kway8_matches_jax_kway8(learned):
    batch, pp, _, _ = learned
    want = jax_learned(batch, pp, E.SimParams(lcap=3, drain_k=8))
    got = port_learned(batch, pp, TE.SimParams(lcap=3, drain_k=8))
    assert_bitwise(want, got, "learned drain_k=8 against the JAX K = 8")


def test_shared_weights_and_heuristic_rows(learned):
    """Shared weights (no leading axis) give each replica the run of its
    own copy; heuristic rows in the same batch are untouched by them."""
    batch, pp, _, _ = learned
    one = jax.tree.map(lambda x: x[1], pp)
    shared = port_learned(batch, one, TE.SimParams(lcap=3))
    each = port_learned(batch, jax.tree.map(
        lambda x: jnp.broadcast_to(x[1], x.shape), pp), TE.SimParams(lcap=3))
    assert_bitwise(shared, each, "shared against stacked copies")
    base = mixed_batch()
    heur = port_run(base, TE.SimParams(lcap=3))
    mixed = interop.replicas_from_numpy(*base, device="cpu")
    pids = mixed.policy_ids.clone()
    pids[::3] = TP.POLICY_IDS["mlp"]
    st = TE.run_sweep(mixed.tasks, mixed.mtype, mixed.tables, pids,
                      TE.SimParams(lcap=3), None, mixed.dynamics,
                      mixed.parents, port_params(one))
    keep = torch.nonzero(pids == mixed.policy_ids)[:, 0]
    assert_bitwise(heur.take(keep), st.take(keep), "heuristics beside mlp")


# --------------------------------------------------------------------------
# Warm starts, oracle, sentinels
# --------------------------------------------------------------------------
def _simulate(seed, policy, pp=None):
    from conftest import make_instance

    from repro_torch.core.eet import EETTable
    from repro_torch.core.workload import Workload
    eet, power, wl, mtype = make_instance(seed)
    return TE.simulate(Workload(wl.arrival, wl.type_id, wl.deadline),
                       EETTable(eet.eet), power, mtype, policy=policy,
                       policy_params=pp, device="cpu")


@pytest.mark.parametrize("seed", [21, 33])
def test_warm_starts_equal_their_heuristics(seed):
    """mlp(mct_mlp_params) is MCT, and mlp / linear with ee_mlp_params
    are ee_mct, bitwise on every state field."""
    if seed == 21:
        assert_bitwise(_simulate(seed, "mct"), _simulate(
            seed, "mlp", NN.mct_mlp_params("cpu")), "mct warm start")
    ee = _simulate(seed, "ee_mct")
    for pol in NN.LEARNED_POLICIES:
        assert_bitwise(ee, _simulate(seed, pol, NN.ee_mlp_params("cpu")),
                       f"{pol} ee warm start")


@pytest.mark.parametrize("policy", NN.LEARNED_POLICIES)
@pytest.mark.parametrize("pseed", PSEEDS)
def test_oracle_equals_jax_oracle(policy, pseed):
    """The port's ``simulate_ref`` equals the JAX oracle (both numpy)
    on every field; its decisions and statuses equal the port's engine,
    the floats to the oracle suite's tolerance."""
    from conftest import make_instance
    eet, power, wl, mtype = make_instance(42 + pseed)
    pp = JN.init_params(pseed)
    args = (wl.arrival, wl.type_id, wl.deadline, eet.eet, power, mtype)
    want = R.simulate_ref(*args, policy=policy, policy_params=pp)
    got = TR.simulate_ref(*args, policy=policy,
                          policy_params=port_params(pp))
    for f in ("status", "machine", "t_start", "t_end", "active_energy",
              "active_time", "makespan"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    st = _simulate(42 + pseed, policy, port_params(pp))
    np.testing.assert_array_equal(st.tasks.status[0].numpy(), got.status)
    np.testing.assert_array_equal(st.tasks.machine[0].numpy(), got.machine)
    np.testing.assert_allclose(st.tasks.t_end[0].numpy(), got.t_end,
                               rtol=1e-5, atol=1e-4)


def test_non_finite_weights_pick_like_jnp_argmin():
    """Scores from non-finite weights (NaN and +-inf) pick the machine
    that the reference's ``jnp.argmin(where(room, scores, BIG))`` picks:
    the masked argmin's plain version puts the first NaN first, as
    ``jnp.argmin`` does."""
    rng = np.random.default_rng(5)
    r, m = 64, 6
    scores = rng.normal(0, 1, (r, m)).astype(np.float32)
    for i in range(r):
        scores[i, rng.integers(0, m, 2)] = rng.choice(
            np.float32([np.nan, np.inf, -np.inf]), 2)
    room = rng.random((r, m)) < 0.7
    room[:, 0] |= ~room.any(1)
    want = np.asarray(jax.vmap(lambda s, k: jnp.argmin(
        jnp.where(k, s, JP.BIG)))(scores, room))
    got, _ = KR.masked_argmin_ref(torch.from_numpy(scores)[:, None],
                                  torch.from_numpy(room)[:, None])
    np.testing.assert_array_equal(got.numpy(), want)
    pp = NN.init_params(0, device="cpu")
    bad = pp._replace(mlp=pp.mlp._replace(
        w1=torch.full_like(pp.mlp.w1, float("nan"))))
    st = _simulate(21, "mlp", bad)
    assert bool((st.tasks.status >= 4).all())
