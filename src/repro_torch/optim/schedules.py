"""Learning-rate schedules: functions of the step (a Python number)."""
from __future__ import annotations

import math


def cosine_schedule(base_lr, total_steps, final_frac=0.1):
    def fn(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr, warmup_steps, total_steps, final_frac=0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def fn(step):
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        return cos(step - warmup_steps)
    return fn
