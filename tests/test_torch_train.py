"""The port's training step against the JAX package, on the CPU, in f32.

The same numpy inputs and the JAX package's own ``init_params`` weights
(carried across with ``interop.lm_params_from_numpy``, every all-zero
leaf given seeded noise first, so no bias or norm offset hides a fault)
go through ``repro.models.model.loss_fn`` under ``jax.value_and_grad``
and through the port's ``models.model.loss_fn`` under
``torch.autograd.grad``, for tiny qwen2-1.5b with ``remat`` on and off:
the loss to 1e-5 relative, each gradient leaf to 1e-4 of the leaf's
largest magnitude (the JAX gradient tree converted like the params).
``chunked_ce_loss`` is held to the reference's with padding and -1
labels; ``adamw_update`` fed the JAX gradients to the JAX update at
rtol 1e-6 through its clip, ``skip_nonfinite`` and bias-correction
branches; ``warmup_cosine`` to the reference's; ``TokenStream`` batches
equal the reference's bit for bit for both sources; the microbatched
step equals the full-batch one (``tests/test_train.py``'s tolerances);
and six steps of the port's ``build_train_step`` follow the JAX step's
loss trajectory to 1e-4.  The loss forward of the MoE (router aux term),
encoder-decoder and vision frontends is held to the reference's too.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data import DataConfig as JDataConfig
from repro.data import TokenStream as JTokenStream
from repro.launch import train as JLT
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.optim import adamw as JADAM
from repro.optim import schedule as JSCHED
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.data import DataConfig, TokenStream, make_stream
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import train as TLT
from repro_torch.models import model as TM
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, constant, global_norm,
                               warmup_cosine)
from repro_torch.optim.adamw import tree_leaves, tree_map

pytestmark = pytest.mark.torch

NAME = "qwen2-1.5b"
JITTER = 0.05
B, S = 4, 40


def jitter_zero_leaves(jparams, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a if np.asarray(a).any() else jnp.asarray(
            JITTER * rng.standard_normal(a.shape), a.dtype), jparams)


def jax_params(jcfg, seed=0):
    return jitter_zero_leaves(jax.jit(lambda key: JM.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(seed)), seed + 9)


def to_port(tree, cfg):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), cfg,
                                device="cpu")


def make_batch(cfg, seed=3, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[0, 5:9] = -1
    return {"tokens": toks, "labels": labels}


def rel_leaf_close(got, want, tol=1e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * float(np.abs(want).max()) + 1e-30, err


@pytest.fixture(scope="module")
def qwen():
    cfg, jcfg = get_arch(NAME).tiny(), jax_get_arch(NAME).tiny()
    jp = jax_params(jcfg)
    return cfg, jcfg, jp, to_port(jp, cfg)


@pytest.fixture(scope="module")
def jax_grads(qwen):
    """JAX value_and_grad of loss_fn, remat on and off."""
    _, jcfg, jp, _ = qwen
    batch = {k: jnp.asarray(v) for k, v in make_batch(jcfg).items()}
    out = {}
    for remat in (True, False):
        jopt = JM.ModelOptions(dtype=jnp.float32, remat=remat, loss_chunk=16)
        fn = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, batch, jcfg, jopt), has_aux=True))
        (loss, mets), grads = fn(jp)
        out[remat] = (float(loss), {k: np.asarray(v) for k, v in
                                    mets.items()}, grads)
    return out


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_and_grads_match_reference(qwen, jax_grads, remat):
    cfg, _, _, params = qwen
    jloss, jmets, jg = jax_grads[remat]
    opt = TM.ModelOptions(dtype=torch.float32, remat=remat, loss_chunk=16)
    tree = tree_map(lambda x: x.clone().requires_grad_(True), params)
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg).items()}
    loss, mets = TM.loss_fn(tree, batch, cfg, opt)
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(mets["ce"].detach()), jmets["ce"],
                               rtol=1e-5)
    assert int(mets["tokens"]) == int(jmets["tokens"]) == B * (S - 1) - 4
    want = tree_leaves(to_port(jg, cfg))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert bool(g.abs().max() > 0)
        rel_leaf_close(g.detach(), w)


def test_remat_changes_no_gradient_bit(qwen):
    """Recomputing each cycle in the backward gives the same bits."""
    cfg, _, _, params = qwen
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg).items()}
    out = []
    for remat in (True, False):
        opt = TM.ModelOptions(dtype=torch.float32, remat=remat, loss_chunk=16)
        tree = tree_map(lambda x: x.clone().requires_grad_(True), params)
        loss, _ = TM.loss_fn(tree, batch, cfg, opt)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(tree))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S_,chunk", [(40, 16), (37, 8), (12, 512)])
def test_chunked_ce_loss_matches_reference(qwen, S_, chunk):
    cfg, jcfg, jp, params = qwen
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((3, S_, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (3, S_)).astype(np.int32)
    labels[1, :] = -1
    jopt = JM.ModelOptions(dtype=jnp.float32, loss_chunk=chunk)
    jl, jc = jax.jit(lambda p, x, lab: JM.chunked_ce_loss(
        p, x, lab, jcfg, jopt))(jp, jnp.asarray(x), jnp.asarray(labels))
    opt = TM.ModelOptions(dtype=torch.float32, loss_chunk=chunk)
    xt = torch.as_tensor(x).requires_grad_(True)
    tl, tc = TM.chunked_ce_loss(params, xt, torch.as_tensor(labels), cfg,
                                opt)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert int(tc) == int(jc) == int((labels >= 0).sum())
    assert tc.dtype == torch.int32
    (gx,) = torch.autograd.grad(tl, xt)
    jgx = jax.grad(lambda x: JM.chunked_ce_loss(
        jp, x, jnp.asarray(labels), jcfg, jopt)[0])(jnp.asarray(x))
    rel_leaf_close(gx, jgx)
    assert bool((gx[1] == 0).all())


def _fresh(opt: OptState) -> OptState:
    return OptState(opt.step.clone(), *(tree_map(torch.clone, t)
                                        for t in opt[1:]))


@pytest.mark.parametrize("what", ["clip", "no clip", "nonfinite skipped",
                                  "nonfinite kept"])
def test_adamw_update_matches_reference(qwen, jax_grads, what):
    """Two updates from ``adamw_init`` (the second at t = 2 exercises the
    bias corrections), fed the JAX gradients, against the JAX update:
    the moments at rtol 1e-6; the master and params at rtol 1e-6 with a
    floor of 1e-6 of the leaf's largest magnitude, since a master entry
    that ``lr * delta`` nearly cancels keeps only the rounding of that
    term (XLA orders the update's few roundings its own way)."""
    cfg, _, jp, params = qwen
    jg = jax_grads[False][2]
    ocfg = dict(grad_clip=0.5 if what == "clip" else 0.0,
                skip_nonfinite=what != "nonfinite kept")
    if what == "clip":
        ocfg["grad_clip"] = 0.5 * float(JADAM.global_norm(jg))
    if what.startswith("nonfinite"):
        first = jax.tree.leaves(jg)[0]
        jg = jax.tree.map(lambda a: a.at[(0,) * a.ndim].set(jnp.nan)
                          if a is first else a, jg)
    jcfg_o = JADAM.AdamWConfig(**ocfg)
    tcfg_o = AdamWConfig(**ocfg)
    jopt = JADAM.adamw_init(jp)
    topt = adamw_init(params)
    grads = to_port(jg, cfg)
    for step in range(2):
        scale = 0.5 + step
        jparams, jopt, jm = JADAM.adamw_update(jg, jopt, jcfg_o, scale,
                                               compute_dtype=jnp.float32)
        tparams, topt, tm = adamw_update(grads, _fresh(topt), tcfg_o,
                                         torch.tensor(scale),
                                         compute_dtype=torch.float32)
        assert int(tm["update_skipped"]) == int(jm["update_skipped"])
        assert int(topt.step) == int(jopt.step)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for tree_t, tree_j, floor in ((tparams, jparams, 1e-6),
                                      (topt.master, jopt.master, 1e-6),
                                      (topt.m, jopt.m, 0.0),
                                      (topt.v, jopt.v, 0.0)):
            for a, b in zip(tree_leaves(tree_t),
                            tree_leaves(to_port(tree_j, cfg))):
                b = b.numpy()
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=1e-6,
                    atol=floor * float(np.nanmax(np.abs(b))))
    if what == "nonfinite skipped":
        assert int(topt.step) == 0
        for a, b in zip(tree_leaves(topt.master), tree_leaves(params)):
            assert torch.equal(a, b)


def test_adamw_update_is_in_place_and_params_are_copies(qwen):
    _, _, _, params = qwen
    opt = adamw_init(params)
    grads = tree_map(torch.ones_like, params)
    masters = tree_leaves(opt.master)
    new_params, new_opt, _ = adamw_update(grads, opt, AdamWConfig(), 1.0,
                                          compute_dtype=torch.float32)
    assert all(a is b for a, b in zip(tree_leaves(new_opt.master), masters))
    assert all(p.data_ptr() != m.data_ptr() for p, m in
               zip(tree_leaves(new_params), masters))
    assert all(m.data_ptr() != p.data_ptr() for m, p in
               zip(masters, tree_leaves(params)))
    ones = [torch.ones(()), torch.full((3,), 2.0)]
    np.testing.assert_allclose(float(global_norm(ones)), np.sqrt(13.0),
                               rtol=1e-7)


def test_warmup_cosine_matches_reference():
    steps = [0, 1, 50, 99, 100, 101, 2500, 9999, 10000, 20000]
    kw = dict(warmup_steps=100, decay_steps=10000, min_ratio=0.1)
    got = warmup_cosine(torch.tensor(steps, dtype=torch.int32), **kw)
    want = np.asarray(JSCHED.warmup_cosine(jnp.asarray(steps, jnp.int32),
                                           **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert float(got[0]) == 0.0 and float(warmup_cosine(100, **kw)) == 1.0
    assert float(got[-1]) == pytest.approx(0.1)
    assert float(warmup_cosine(5, warmup_steps=0, decay_steps=10)) \
        == pytest.approx(float(JSCHED.warmup_cosine(5, warmup_steps=0,
                                                    decay_steps=10)))
    np.testing.assert_array_equal(
        constant(torch.tensor(steps), value=0.25).numpy(),
        np.asarray(JSCHED.constant(jnp.asarray(steps), value=0.25)))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_token_stream_synthetic_bitwise(n_shards):
    kw = dict(vocab_size=300, seq_len=33, global_batch=4, seed=5)
    t, j = TokenStream(DataConfig(**kw)), JTokenStream(JDataConfig(**kw))
    for step in (0, 1, 7):
        for shard in range(n_shards):
            got = t.batch_at(step, shard=shard, n_shards=n_shards)
            want = j.batch_at(step, shard=shard, n_shards=n_shards)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype == np.int32
                assert np.array_equal(got[key], want[key])
    assert make_stream(DataConfig(**kw)).next_batch()["tokens"].shape \
        == (4, 33)


def test_token_stream_corpus_bitwise(tmp_path):
    path = tmp_path / "corpus.npy"
    np.save(path, np.random.default_rng(1).integers(
        0, 60000, 1000).astype(np.uint16))
    kw = dict(vocab_size=60000, seq_len=16, global_batch=6,
              source="corpus", corpus_path=str(path))
    t, j = TokenStream(DataConfig(**kw)), JTokenStream(JDataConfig(**kw))
    for step in (0, 3, 10, 11):        # 96 tokens a step: 10, 11 wrap
        got, want = t.batch_at(step), j.batch_at(step)
        for key in ("tokens", "labels"):
            assert np.array_equal(got[key], want[key])
    t.next_batch()
    assert t.state.to_dict() == {"step": 1}


def test_shapes_match_reference():
    from repro.configs.base import SHAPES as JSHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def _port_step(cfg, mb, warmup=2):
    opt = TM.ModelOptions(dtype=torch.float32, remat=False, loss_chunk=16)
    scfg = TLT.TrainStepConfig(microbatches=mb, compute_dtype=torch.float32,
                               warmup_steps=warmup)
    return TLT.build_train_step(cfg, opt, AdamWConfig(lr=1e-2), scfg, "cpu")


def test_microbatch_grads_match_full_batch(qwen):
    """mb = 4 accumulation equals the single-shot gradient step, as the
    reference's ``test_microbatch_grads_match_full_batch`` holds it."""
    cfg, _, _, params = qwen
    batch = make_stream(DataConfig(cfg.vocab_size, 32, 4, seed=1)).batch_at(0)
    out = []
    for mb in (1, 4):
        p = tree_map(torch.clone, params)
        out.append(_port_step(cfg, mb, warmup=0)(p, adamw_init(p), batch))
    (p1, _, m1), (p4, _, m4) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5,
                                   rtol=3e-4)
    assert float(m1["lr_scale"]) == 1.0 and int(m4["update_skipped"]) == 0


def test_microbatches_take_strided_rows(qwen, monkeypatch):
    cfg, _, _, params = qwen
    seen = []
    orig = TM.loss_fn

    def spy(p, batch, *a, **k):
        seen.append(batch["tokens"].clone())
        return orig(p, batch, *a, **k)
    monkeypatch.setattr(TM, "loss_fn", spy)
    batch = make_batch(cfg, b=4, s=8)
    p = tree_map(torch.clone, params)
    _port_step(cfg, 2)(p, adamw_init(p), batch)
    assert [s.tolist() for s in seen] == [batch["tokens"][0::2].tolist(),
                                          batch["tokens"][1::2].tolist()]


def test_six_step_trajectory_matches_reference(qwen):
    """Six steps of ``build_train_step`` at 2 microbatches, warmup 2,
    from the same weights and the same token stream: the losses follow
    the JAX step's to 1e-4 (Adam's m / sqrt(v) amplifies the rounding
    of small gradients, so the params drift apart faster than the
    loss)."""
    cfg, jcfg, jp, params = qwen
    mesh = make_local_mesh()
    jopt = JM.ModelOptions(dtype=jnp.float32, remat=False, loss_chunk=16)
    jstep = jax.jit(JLT.build_train_step(
        jcfg, jopt, JADAM.AdamWConfig(lr=1e-2),
        JLT.TrainStepConfig(microbatches=2, compute_dtype=jnp.float32,
                            warmup_steps=2), mesh))
    tstep = _port_step(cfg, 2)
    stream = make_stream(DataConfig(cfg.vocab_size, 24, 4, seed=2))
    jstate = (jp, JADAM.adamw_init(jp))
    tp = tree_map(torch.clone, params)
    tstate = (tp, adamw_init(tp))
    jl, tl = [], []
    for step in range(6):
        batch = stream.batch_at(step)
        jparams, jo, jm = jstep(*jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        jstate = (jparams, jo)
        tparams, to, tm = tstep(*tstate, batch)
        tstate = (tparams, to)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["lr_scale"]),
                                   float(jm["lr_scale"]), rtol=1e-6)
        assert int(tm["update_skipped"]) == int(jm["update_skipped"]) == 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "seamless-m4t-large-v2",
                                  "phi-3-vision-4.2b"])
def test_frontend_and_moe_loss_match_reference(name):
    """The loss forward's other branches: the MoE router's aux term, the
    encoder's non-causal stack over frames, the vision patch splice."""
    cfg, jcfg = get_arch(name).tiny(), jax_get_arch(name).tiny()
    jp = jax_params(jcfg, seed=1)
    params = to_port(jp, cfg)
    rng = np.random.default_rng(4)
    s = 16
    batch = make_batch(cfg, b=2, s=s)
    if cfg.is_encdec:
        batch["frames"] = (0.1 * rng.standard_normal(
            (2, s, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    jopt = JM.ModelOptions(dtype=jnp.float32, remat=False, loss_chunk=8)
    jl, jm = jax.jit(lambda p, b: JM.loss_fn(p, b, jcfg, jopt))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = TM.ModelOptions(dtype=torch.float32, remat=False, loss_chunk=8)
    with torch.no_grad():
        tl, tm = TM.loss_fn(params, {k: torch.as_tensor(v)
                                     for k, v in batch.items()}, cfg, opt)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=1e-4, atol=1e-6)
    if cfg.moe is not None:
        assert float(tm["aux"]) > 0
