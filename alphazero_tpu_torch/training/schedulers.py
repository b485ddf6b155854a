"""Learning-rate schedules (counterpart of
``alphazero_tpu/training/schedulers.py``): functions from the optimizer's
update count to a learning rate, as Python floats.

``warmup_cosine`` is optax's ``warmup_cosine_decay_schedule`` with
``init_value=0``: a linear ramp from 0 to ``base_lr`` over the warm-up, then
a cosine decay to ``base_lr * final_lr_frac``.  optax evaluates a schedule
at the update count *before* it increments, so the first update of a fresh
run has learning rate 0; ``training/learner.py`` does the same.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_lr_frac: float = 0.0) -> Schedule:
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    end = base_lr * final_lr_frac
    alpha = 0.0 if base_lr == 0.0 else end / base_lr

    def schedule(step: int) -> float:
        if step < warmup:  # optax linear_schedule from 0 to base_lr
            return -base_lr * (1.0 - step / warmup) + base_lr
        t = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def linear_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        return base_lr * min(step / max(warmup_steps, 1), 1.0)

    return schedule


def cyclic_cosine(base_lr: float, cycle_steps: int,
                  min_lr_frac: float = 0.01) -> Schedule:
    def schedule(step: int) -> float:
        t = (step % cycle_steps) / max(cycle_steps, 1)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        lo = base_lr * min_lr_frac
        return lo + (base_lr - lo) * cos

    return schedule


def step_decay(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch.optim.lr_scheduler.StepLR's schedule (train.py's "step")."""

    def schedule(step: int) -> float:
        return base_lr * gamma ** (step // step_size)

    return schedule


def make(name: str, base_lr: float, total_steps: int, warmup_steps: int = 0,
         **kw) -> Schedule:
    if name in ("warmup_cosine", "cosine"):
        return warmup_cosine(base_lr, warmup_steps, total_steps, **kw)
    if name == "linear_warmup":
        return linear_warmup(base_lr, warmup_steps)
    if name == "cyclic_cosine":
        return cyclic_cosine(base_lr, kw.get("cycle_steps", total_steps // 4 or 1))
    if name == "step":
        return step_decay(base_lr, kw.get("step_size", total_steps // 3 or 1),
                          kw.get("gamma", 0.1))
    if name == "constant":
        return lambda step: base_lr
    raise ValueError(f"unknown scheduler {name!r}")
