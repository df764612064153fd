"""Optimizer and schedules of the training step (``repro/optim``'s
single-device half; ``compression.py`` and the ZeRO-1 specs wait for the
distributed slice, ROADMAP queue A, item 11.6)."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "global_norm", "warmup_cosine", "constant"]
