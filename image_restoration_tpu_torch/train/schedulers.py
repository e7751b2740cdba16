"""Learning-rate schedules as plain functions of the step that return floats
(image_restoration_tpu/train/schedulers.py, whose jnp versions these copy).

Reproduces the zoo's scheduler inventory (SURVEY.md §2.3 LR schedulers):
LinearWarmupCosineAnnealingLR (MoCE-IR schedulers.py:239+),
CosineAnnealingRestart(Cyclic)LR (schedulers.py:140-236, HOGformer's config),
MultiStepRestartLR (:11-51), LinearLR (:53-74), VibrateLR (:76-117),
GradualWarmupScheduler (NeRD-Rain warmup_scheduler/scheduler.py:5-38),
MultiStepLR / CosineAnnealingLR (torch built-ins used by SRConvNet/DarkIR).

All are closed-form in the step index, so a resumed run needs no scheduler
state. The trainer's update n (counted from 0, optax's count) takes
``schedule(n)``; ``torch.optim.lr_scheduler.LambdaLR`` would be one step
off against that, so the trainer does not use it. The host computes each
rate in float64, the JAX functions in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np


def linear_warmup_cosine(base_lr: float, warmup_steps: int, max_steps: int,
                         warmup_start_lr: float = 0.0, eta_min: float = 0.0):
    def sched(step):
        if step < warmup_steps:
            return warmup_start_lr + (base_lr - warmup_start_lr) * max(
                step, 0) / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * t))

    return sched


def cosine_annealing(base_lr: float, t_max: int, eta_min: float = 0.0):
    def sched(step):
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * step / t_max))

    return sched


def cosine_annealing_restart_cyclic(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1.0,),
    eta_mins: Sequence[float] = (0.0,),
):
    """HOGformer recipe: e.g. periods [92k, 208k], weights [1, 1],
    eta_mins [3e-4, 1e-6] (Allweather_HOGformer.yml)."""
    cum = np.cumsum(periods)
    starts = np.concatenate([[0], cum[:-1]])

    def sched(step):
        # index of the current cycle: right-closest (iteration <= cumsum)
        idx = int(np.sum(step > cum - 0.5))
        idx = min(max(idx, 0), len(periods) - 1)
        emin = eta_mins[idx]
        return emin + restart_weights[idx] * 0.5 * (base_lr - emin) * (
            1 + math.cos(math.pi * (step - starts[idx]) / periods[idx]))

    return sched


def cosine_annealing_restart(base_lr, periods, restart_weights=(1.0,), eta_min=0.0):
    return cosine_annealing_restart_cyclic(
        base_lr, periods, restart_weights, tuple(eta_min for _ in periods)
    )


def multistep(base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
    ms = np.asarray(sorted(milestones))

    def sched(step):
        return base_lr * gamma ** int(np.sum(step >= ms))

    return sched


def multistep_restart(base_lr, milestones, gamma=0.1, restarts=(0,), restart_weights=(1.0,)):
    """MultiStepRestartLR: gamma decays at milestones; lr resets to
    base*weight at restart iterations."""
    rs = np.asarray(restarts)
    ms = np.asarray(sorted(milestones))

    def sched(step):
        # weight of the most recent restart at or before step
        ridx = min(max(int(np.sum(step >= rs)) - 1, 0), len(restarts) - 1)
        n = int(np.sum((ms > rs[ridx]) & (step >= ms)))
        return base_lr * restart_weights[ridx] * gamma**n

    return sched


def linear_decay(base_lr: float, total_steps: int):
    def sched(step):
        return base_lr * (1.0 - step / total_steps)

    return sched


def vibrate(base_lr: float, total_steps: int):
    """VibrateLR (schedulers.py:76-117): triangle wave of period
    total/80 under a piecewise-linear decaying envelope."""
    T = max(total_steps // 80, 2)
    Th = T // 2

    def sched(step):
        process = step / total_steps
        if process < 3 / 8:
            f = 1 - process * 8 / 3
        else:
            f = 0.2 if process < 5 / 8 else 0.1
        t = step % T
        f2 = t / Th
        if t >= Th:
            f2 = 2 - f2
        w = f * f2
        if step < Th:
            w = max(w, 0.1)
        return base_lr * w

    return sched


def gradual_warmup(base_lr: float, multiplier: float, warmup_steps: int,
                   after: Callable | None = None):
    """GradualWarmupScheduler: lr ramps base->base*multiplier over warmup,
    then hands off to ``after`` (stepped from 0)."""

    def sched(step):
        warm = base_lr * ((multiplier - 1) * min(step, warmup_steps)
                          / warmup_steps + 1)
        if after is None or step < warmup_steps:
            return warm
        return after(step - warmup_steps)

    return sched


SCHEDULES = {
    "linear_warmup_cosine": linear_warmup_cosine,
    "cosine": cosine_annealing,
    "cosine_restart": cosine_annealing_restart,
    "cosine_restart_cyclic": cosine_annealing_restart_cyclic,
    "multistep": multistep,
    "multistep_restart": multistep_restart,
    "linear": linear_decay,
    "vibrate": vibrate,
    "gradual_warmup": gradual_warmup,
    "constant": lambda base_lr: (lambda step: float(base_lr)),
}


def cosine_loss_weight(step: int, total_steps: int, target_weight: float) -> float:
    """Inverted-cosine loss-weight ramp 0 -> target
    (IGMoCE-IR-main/src/utils/weight_schedule.py:get_cosine_weight)."""
    return (1 - math.cos(math.pi * (step / total_steps))) / 2 * target_weight
