"""LR schedules as step -> lr callables (``repro/optim/schedule.py``): f32
0-dim tensors on the step's device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor`` at ``total``."""
    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn
