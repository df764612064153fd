"""The flash kernel's non-causal modes and head widths 64 and 96, the
grouped matmul at 128 groups, and the tiny forms of the six newest
configurations on a card against the CPU.

Needs an NVIDIA GPU and skips with a reason without one; imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_frontends.py

Tolerances: the kernels within atol = rtol = 2e-5 of their plain
versions in f32 (the grouped matmul's atol scaled by D, its padding rows
exactly 0); the tiny models (a prompt of 24, 6 decode steps; seeded noise on the
zero-initialized leaves, every xLSTM block checked to add a nonzero
output) within atol = rtol = 1e-4 of the CPU run on every logit, in f32,
with the flash launches counted (none for an xLSTM layer; the encoder's
and each cross-attention's for seamless).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import grouped_matmul as GMM

pytestmark = [pytest.mark.torch, pytest.mark.cuda]

ARCHS = ("xlstm-350m", "command-r-35b", "qwen2-72b", "qwen3-moe-235b-a22b",
         "phi-3-vision-4.2b", "seamless-m4t-large-v2")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bh,sq,sk,hd,causal", [
    (4, 64, 64, 64, False), (3, 50, 130, 64, False), (3, 1, 130, 64, False),
    (2, 100, 100, 96, True), (2, 70, 130, 96, False), (3, 1, 77, 96, False)])
def test_flash_kernel_new_modes(cuda_device, bh, sq, sk, hd, causal):
    g = torch.Generator().manual_seed(bh * sq + hd)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((bh, sq, hd), (bh, sk, hd), (bh, sk, hd)))
    before = FA.launches["flash_attention"]
    got = FA.flash_attention(q.to(cuda_device), k.to(cuda_device),
                             v.to(cuda_device), causal=causal)
    assert FA.launches["flash_attention"] == before + 1
    torch.testing.assert_close(got.cpu(), FA.flash_attention_ref(
        q, k, v, causal=causal), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("c", [8, 80])
def test_grouped_matmul_128_groups(cuda_device, c):
    g = torch.Generator().manual_seed(c)
    lhs = torch.randn((128, c, 96), generator=g)
    rhs = torch.randn((128, 96, 64), generator=g)
    sizes = torch.randint(0, c + 1, (128,), generator=g).to(torch.int32)
    sizes[:2] = torch.tensor([0, c], dtype=torch.int32)
    got = GMM.grouped_matmul(lhs.to(cuda_device), rhs.to(cuda_device),
                             sizes.to(cuda_device)).cpu()
    torch.testing.assert_close(got, GMM.grouped_matmul_ref(lhs, rhs, sizes),
                               atol=2e-5 * 96, rtol=2e-5)
    pad = torch.arange(c)[None, :] >= sizes[:, None].long()
    assert bool((got[pad] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_model_card_equals_cpu(cuda_device, arch):
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as M
    cfg = get_arch(arch).tiny()
    gen = torch.Generator().manual_seed(0)
    params = _live(M.init_params(gen, cfg), gen)
    _assert_xlstm_live(params, cfg)
    card = _tree_to(params, cuda_device)
    opt = M.ModelOptions(dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 24)))}
    if cfg.is_encdec:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (2, 30, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    cl = 24 + 6
    kinds = cfg.kinds()
    n_attn = sum(k not in ("rec", "mlstm", "slstm") for k in kinds)
    cross = len(kinds) if cfg.is_encdec else 0
    FA.reset_launches()
    want, wc = M.prefill(params, batch, cfg, opt, cache_len=cl)
    got, gc = M.prefill(card, {k: v.to(cuda_device) for k, v in
                               batch.items()}, cfg, opt, cache_len=cl)
    assert FA.launches["flash_attention"] \
        == n_attn + cross + cfg.n_encoder_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for step in range(6):
        tok = want[:, -1].argmax(-1)[:, None]
        want, wc = M.decode_step(params, wc, tok, cfg, opt)
        got, gc = M.decode_step(card, gc, tok.to(cuda_device), cfg, opt)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert FA.launches["flash_attention"] \
        == n_attn + cross * 7 + cfg.n_encoder_layers


def _live(tree, gen):
    """Seeded noise of scale 0.1 in place of every all-zero leaf (conv
    taps, biases, norm offsets): with zero conv taps every xLSTM block
    adds exactly 0, and the card would match the CPU whatever it
    computed there."""
    if isinstance(tree, dict):
        return {k: _live(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_live(v, gen) for v in tree]
    return tree if bool(tree.any()) else 0.1 * torch.randn(
        tree.shape, generator=gen, dtype=tree.dtype)


def _assert_xlstm_live(params, cfg):
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as XL
    x = torch.randn((1, 6, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    for j, kind in enumerate(M.layout(cfg).cycle):
        fn = {"mlstm": XL.apply_mlstm_block,
              "slstm": XL.apply_slstm_block}.get(kind)
        for p in params["stack"]["cycle"][j] if fn else ():
            assert float(fn(p["cell"], x, cfg.n_heads)[0].abs().max()) \
                > 1e-3, (cfg.name, kind, j)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)
