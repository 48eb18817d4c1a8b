"""LR schedules, pure functions of the step (the port's counterpart of
``repro.optim.schedule``), in float32 as the reference's."""
from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step, *, warmup: int, total: int,
                         min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``min_ratio`` at ``total``.  A 0-d float32 tensor on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step) -> float:
    return 1.0
