"""E2C simulator ported to PyTorch, with hand-written CUDA kernels for Hopper.

A second package beside the JAX reference in ``src/repro/``, laid out
module for module like it (``core/``, ``kernels/``, ``launch/``) so each
module's counterpart is easy to find.  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.

Every state tensor carries a leading replica axis R: one event step
advances every unfinished replica under a mask, which is what ``vmap``
does to the reference engine's batched ``lax.while_loop``.

Entry points take an explicit ``device=`` that defaults to ``"cuda"``;
pass ``device="cpu"`` to run on the CPU, where each kernel wrapper
computes its plain PyTorch version instead of launching the kernel.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on; raises when CUDA was asked for
    (the default) but no GPU is present — there is no silent CPU
    fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
