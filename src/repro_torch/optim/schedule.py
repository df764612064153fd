"""Learning-rate schedules: a copy of ``repro/optim/schedule.py``.

Each takes the step (an int or an integer tensor, on any device) and
returns the multiplier applied to the peak learning rate as a float32
tensor on the step's device, in the reference's order of operations.
"""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, warmup_steps: int = 100, decay_steps: int = 10000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1.0 (0 at step 0), cosine decay to ``min_ratio``
    at ``decay_steps`` and flat after."""
    step = _step_f32(step)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(_step_f32(step), value)
