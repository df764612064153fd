"""The multiply-add kernel and tiny gemma3-12b and recurrentgemma-2b on a
card against the CPU.

Needs an NVIDIA GPU and skips with a reason without one; imports neither
JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_gemma.py

Tolerances: the multiply-add kernel bitwise its CPU twin (``reduce.fma``)
on the forward pass's broadcast shapes and on the queue C probe (a
product below half an ulp of the sum, which a twice-rounded sum gets
wrong); the tiny models (a prompt of 24 past the tiny window of 16, then
decode past the ring's wrap) within atol = rtol = 1e-4 of the CPU run on
every logit, in f32, with the flash kernel's local and global prefill
launches counted.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fma as FMA
from repro_torch.kernels import ref as KREF

pytestmark = [pytest.mark.torch, pytest.mark.cuda]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bits(x):
    return x.cpu().view(torch.int32)


@pytest.mark.parametrize("shapes", [
    ((64, 32, 1), (16,), (64, 32, 16)),
    ((64, 32, 4, 1), (4, 16), (64, 32, 4, 16)),
    ((64, 32, 8), (64, 1, 8), (64, 32, 8)),
    ((4096,), (4096,), (4096,))])
def test_fma_kernel_bitwise_cpu_twin(cuda_device, shapes):
    g = torch.Generator().manual_seed(len(shapes[0]))
    args = [torch.randn(s, generator=g) for s in shapes]
    before = FMA.launches["fma"]
    got = FMA.fma(*(a.to(cuda_device) for a in args))
    assert FMA.launches["fma"] == before + 1
    assert torch.equal(_bits(got), _bits(KREF.fma_ref(*args)))


def test_fma_kernel_queue_c_probe(cuda_device):
    x = np.float32(2**-12 * (1 + 2**-18))
    w = np.float32(2**-12 * (1 - 2**-18))
    acc = np.float32(1 + 2**-23)
    got = FMA.fma(torch.full((8, 1), float(x), device=cuda_device),
                  torch.full((3,), float(w), device=cuda_device),
                  torch.full((8, 3), float(acc), device=cuda_device))
    assert bool((got.cpu() == torch.tensor(acc)).all())


def test_fma_kernel_refuses_32_bit_overflow(cuda_device):
    """Past 2^31 elements the wrapper raises before it allocates, and the
    launcher itself returns an error without launching."""
    from repro_torch.kernels import build
    x = torch.ones((2**16, 1), device=cuda_device)
    w = torch.ones((1, 2**16), device=cuda_device)
    acc = torch.ones((1,), device=cuda_device)
    before = FMA.launches["fma"]
    with pytest.raises(ValueError, match="32-bit"):
        FMA.fma(x, w, acc)
    assert FMA.launches["fma"] == before
    s = torch.Size([2**16, 2**16])
    g = FMA.geometry(s, x, w, acc)
    code = build.load("fma").e2c_fma(x.data_ptr(), w.data_ptr(),
                                     acc.data_ptr(), x.data_ptr(), g,
                                     torch.cuda.current_stream().cuda_stream)
    assert code != 0


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-2b"])
def test_tiny_model_card_equals_cpu(cuda_device, arch):
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model as M
    cfg = get_arch(arch).tiny(**({"n_layers": 8}
                                 if arch == "recurrentgemma-2b" else {}))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    card = _tree_to(params, cuda_device)
    opt = M.ModelOptions(dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    cl = 24 + 6
    FA.reset_launches()
    want, wc = M.prefill(params, {"tokens": prompt}, cfg, opt, cache_len=cl)
    got, gc = M.prefill(card, {"tokens": prompt.to(cuda_device)}, cfg, opt,
                        cache_len=cl)
    n_attn = len(cfg.kinds()) - cfg.kinds().count("rec")
    assert FA.launches["flash_attention"] == n_attn
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for _ in range(6):
        tok = want[:, -1].argmax(-1)[:, None]
        want, wc = M.decode_step(params, wc, tok, cfg, opt)
        got, gc = M.decode_step(card, gc, tok.to(cuda_device), cfg, opt)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)
