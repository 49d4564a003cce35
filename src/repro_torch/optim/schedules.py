"""LR schedules (pure functions of step); a copy of ``repro.optim.schedules``."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step: int) -> float:
        if step < warmup:
            return lr * (step + 1) / max(warmup, 1)
        frac = (step - warmup) / max(total - warmup, 1)
        frac = min(max(frac, 0.0), 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * frac)))
    return f
