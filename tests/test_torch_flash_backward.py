"""The gradient of the port's flash attention against PyTorch's autograd
and the JAX package, on the CPU; its CUDA kernels on a card.

``flash_attention_bwd_ref`` (the plain twin of the backward kernels:
P = exp(x - lse), dV = P^T dO, dS = P (dP - rowsum(dO O)), the softcap's
1 - tanh^2, hd**-0.5) is held against ``torch.autograd`` of
``flash_attention_ref`` and against ``jax.vjp`` of the JAX package's
``models/attention.py::flash_chunked``, the function the JAX package
trains through (it has no Pallas backward), on the same numpy inputs, at
atol = rtol = 1e-5 in f32; ``flash_attention_fwd_ref``'s ``lse`` against
the JAX stats' m + log(l).  The cases cover causal, a window, a softcap,
non-causal Sq < Sk, and rows with no visible key (zero gradient, never
NaN).  The wrapper's CPU route is the plain version, differentiable.

The ``cuda`` cases need an NVIDIA GPU and skip with a reason without one
(a CUDA kernel has no CPU mode).  They hold ``flash_attention_bwd``
through ``flash_attention``'s autograd route against the plain twin fed
the kernel's own o and lse, at ``max|dX - dX_ref| <= 1e-4 max|dX_ref|``
(f32) and 2e-2 (bf16), each launched twice with bitwise-equal results
(a softcap of 5 on logits of std 4 among the cases, where a missing
1 - tanh^2 shows), the forward with ``lse`` bitwise the forward
without, a ``grad_fn`` on the output of a call under grad, and the
grouped matmul's refusal under grad.  JAX is imported inside the CPU
tests' fixture only, so on the card the file runs without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_flash_backward.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import grouped_matmul as TGMM

pytestmark = pytest.mark.torch

TOL = dict(atol=1e-5, rtol=1e-5)
# (BH, Sq, Sk, hd, causal, window, softcap, what)
CASES = [
    (3, 40, 40, 16, True, 0, 0.0, "causal"),
    (2, 48, 48, 32, True, 16, 0.0, "causal window 16"),
    (2, 33, 33, 16, True, 0, 20.0, "causal softcap 20"),
    (2, 40, 40, 16, True, 8, 5.0, "window 8 and softcap 5"),
    (2, 24, 56, 16, False, 0, 0.0, "non-causal Sq < Sk"),
    (2, 32, 32, 24, False, 0, 0.0, "non-causal Sq = Sk"),
    (2, 64, 20, 16, True, 8, 0.0, "rows with no visible key"),
]
IDS = [c[-1] for c in CASES]


def _draw(seed, bh, sq, sk, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, sq, hd), (bh, sk, hd), (bh, sk, hd), (bh, sq, hd))]


def _jax_case(q, k, v, do, causal, window, softcap):
    """jax.vjp of the JAX flash_chunked, and its m + log(l), one head of
    batch BH, jitted: -> (o, lse, dq, dk, dv) as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JATT
    qp, kp = jnp.arange(q.shape[1]), jnp.arange(k.shape[1])
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=16)

    def run(q, k, v, do):
        def f(q, k, v):
            return JATT.flash_chunked(q[:, :, None], k[:, :, None],
                                      v[:, :, None], qp, kp, **kw)[:, :, 0]
        o, vjp = jax.vjp(f, q, k, v)
        m, l, _ = JATT.flash_chunked_stats(q[:, :, None], k[:, :, None],
                                           v[:, :, None], qp, kp, **kw)
        m, l = m[:, 0, 0], l[:, 0, 0]
        lse = jnp.where(l > 0, m + jnp.log(jnp.maximum(l, 1e-30)), 0.0)
        return (o, lse) + vjp(do)
    out = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do)))
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def jax_results():
    """Every case through the JAX package once."""
    pytest.importorskip("jax")
    out = {}
    for i, (bh, sq, sk, hd, causal, window, softcap, what) in \
            enumerate(CASES):
        q, k, v, do = _draw(i, bh, sq, sk, hd)
        out[what] = _jax_case(q, k, v, do, causal, window, softcap)
    return out


def _t(x):
    return torch.as_tensor(x.copy())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_autograd_and_jax(case, jax_results):
    bh, sq, sk, hd, causal, window, softcap, what = case
    q, k, v, do = _draw(CASES.index(case), bh, sq, sk, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = TFA.flash_attention_fwd_ref(_t(q), _t(k), _t(v), **kw)
    dq, dk, dv = TFA.flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse,
                                             _t(do), **kw)
    # torch.autograd of the dense plain forward
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = TFA.flash_attention_ref(qt, kt, vt, **kw)
    out.backward(_t(do))
    for got, want in ((o, out.detach()), (dq, qt.grad), (dk, kt.grad),
                      (dv, vt.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # jax.vjp of flash_chunked
    jo, jlse, jdq, jdk, jdv = jax_results[what]
    for got, want in ((o, jo), (lse, jlse), (dq, jdq), (dk, jdk),
                      (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()


def test_rows_with_no_visible_key_have_zero_gradient():
    bh, sq, sk, hd, causal, window, softcap, _ = CASES[-1]
    q, k, v, do = (_t(x) for x in _draw(99, bh, sq, sk, hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = TFA.flash_attention_fwd_ref(q, k, v, **kw)
    dq, dk, dv = TFA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    empty = ~TFA.visible_mask(sq, sk, causal=causal, window=window).any(-1)
    assert int(empty.sum()) > 0
    assert bool((o[:, empty] == 0).all()) and bool((lse[:, empty] == 0).all())
    assert bool((dq[:, empty] == 0).all())
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() \
        and torch.isfinite(dv).all()


@pytest.mark.parametrize("causal,window,softcap",
                         [(True, 0, 0.0), (True, 8, 10.0), (False, 0, 0.0)])
def test_wrapper_cpu_route_is_differentiable(causal, window, softcap):
    """On the CPU ``flash_attention`` is the plain forward, whose autograd
    equals ``flash_attention_bwd`` (the plain twin there)."""
    q, k, v, do = (_t(x) for x in _draw(7, 2, 30, 30, 16))
    kw = dict(causal=causal, window=window, softcap=softcap)
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    TFA.flash_attention(qt, kt, vt, **kw).backward(do)
    o, lse = TFA.flash_attention_fwd_ref(q, k, v, **kw)
    for got, want in zip(TFA.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                         (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_bwd_rejects_bad_shapes():
    q, k, v, do = (_t(x) for x in _draw(1, 2, 8, 8, 16))
    o, lse = TFA.flash_attention_fwd_ref(q, k, v)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, o, lse[:, :4], do)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, o[:, :4], lse, do)


def _bwd_without_tanh_factor(q, k, v, o, lse, do, *, causal, window,
                             softcap):
    """``flash_attention_bwd_ref`` with the softcap's 1 - tanh^2 left out:
    the fault the card's softcap cases must be able to show."""
    x = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    x = softcap * torch.tanh(x / softcap)
    mask = TFA.visible_mask(q.shape[1], k.shape[1], causal=causal,
                            window=window)
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    dof = do.float()
    dp = torch.einsum("bqh,bkh->bqk", dof, v.float())
    ds = p * (dp - (dof * o.float()).sum(dim=-1, keepdim=True)) \
        * (q.shape[-1] ** -0.5)
    return (torch.einsum("bqk,bkh->bqh", ds, k.float()),
            torch.einsum("bqk,bqh->bkh", ds, q.float()))


@pytest.mark.parametrize("softcap,scale,shows", [(50.0, 1.0, False),
                                                 (5.0, 4.0, True)],
                         ids=["softcap 50, logits of std 1",
                              "softcap 5, logits of std 4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_softcap_cases_see_the_tanh_derivative(softcap, scale, shows,
                                               dtype):
    """At the cuda cases' 2 x 300 x 300 x 256 with window 100, a backward
    without 1 - tanh^2 stays inside bf16's 2e-2 of the largest gradient
    at softcap 50 on logits of std 1, and misses by more than half of it
    at softcap 5 on logits of std 4 (q scaled by 4): the card's cases
    need the second to check the factor."""
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(2, 300, 256, generator=g).to(dtype)
                   for _ in range(4))
    q = q * scale
    kw = dict(causal=True, window=100, softcap=softcap)
    o, lse = TFA.flash_attention_fwd_ref(q, k, v, **kw)
    want = TFA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    bad = _bwd_without_tanh_factor(q, k, v, o, lse, do, **kw)
    miss = min(float((b - w.float()).abs().max() / w.float().abs().max())
               for b, w in zip(bad, want))
    if shows:
        assert miss > 0.5, miss
    else:
        assert 1e-4 < miss < 2e-2, miss


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# (BH, Sq, Sk, hd, causal, window, softcap, q scale): q scaled by 4 and a
# softcap of 5 bend the logits (std 4) far into tanh's curve, so that a
# kernel without the 1 - tanh^2 factor fails both tolerances
CUDA_CASES = [
    (4, 256, 256, 128, True, 0, 0.0, 1.0),
    (2, 1000, 1000, 64, True, 0, 0.0, 1.0),
    (2, 300, 300, 256, True, 100, 50.0, 1.0),
    (2, 130, 130, 96, False, 0, 0.0, 1.0),
    (2, 70, 200, 96, False, 0, 0.0, 1.0),
    (2, 96, 32, 64, True, 16, 0.0, 1.0),
    (2, 50, 70, 37, True, 0, 0.0, 1.0),
    (2, 300, 300, 256, True, 100, 5.0, 4.0),
]


def _kernel_route(q, k, v, kw):
    """``flash_attention`` under grad on the card (the ``FlashAttention``
    route): -> (leaves, out, the kernel's o and lse as the backward reads
    them)."""
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = TFA.flash_attention(*leaves, **kw)
    *_, o, lse = out.grad_fn.saved_tensors
    return leaves, out, o.detach(), lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_bwd_kernel_matches_plain(cuda_device, dtype, case):
    bh, sq, sk, hd, causal, window, softcap, scale = case
    kw = dict(causal=causal, window=window, softcap=softcap)
    g = torch.Generator(device="cpu").manual_seed(sq + hd)
    q, k, v, do = (torch.randn(s, generator=g).to(cuda_device, dtype)
                   for s in ((bh, sq, hd), (bh, sk, hd), (bh, sk, hd),
                             (bh, sq, hd)))
    q = q * scale
    leaves, out, o, lse = _kernel_route(q, k, v, kw)
    with torch.no_grad():
        plain = TFA.flash_attention(q, k, v, **kw)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(o.view(bits), plain.view(bits))
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    again = torch.autograd.grad(out, leaves, do)
    want = TFA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        err = float((a.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err


@pytest.mark.cuda
def test_cuda_flash_output_carries_grad(cuda_device):
    q, k, v = (torch.randn(2, 64, 32, device=cuda_device,
                           requires_grad=True) for _ in range(3))
    out = TFA.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(x.grad is not None and bool(x.grad.abs().sum() > 0)
               for x in (q, k, v))


@pytest.mark.cuda
def test_cuda_grouped_matmul_refuses_grad(cuda_device):
    lhs = torch.randn(2, 8, 16, device=cuda_device, requires_grad=True)
    rhs = torch.randn(2, 16, 8, device=cuda_device)
    sizes = torch.tensor([8, 3], dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="11.5"):
        TGMM.grouped_matmul(lhs, rhs, sizes)
    with torch.no_grad():
        assert TGMM.grouped_matmul(lhs, rhs, sizes).grad_fn is None
