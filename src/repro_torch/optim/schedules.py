"""Learning-rate schedules: plain functions of the step count (the port's
copy of ``repro.optim.schedules``)."""
from __future__ import annotations

import math


def constant(value: float):
    return lambda count: value


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warmup to ``peak`` over ``warmup_steps``, then a cosine decay
    to ``floor`` at ``total_steps``."""
    def sched(count):
        c = float(count)
        if c < warmup_steps:
            return peak * min(1.0, c / max(warmup_steps, 1))
        prog = min(max((c - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * prog))

    return sched
