"""Learning-rate schedules as functions of the optimizer step.

Counterpart of ``lic_tpu/training/schedule.py``: each function returns
``lr(step)``, the rate of the update at ``step`` (0 for the first), as the
optax schedules there do, and in their arithmetic: fp32, operation for
operation (``np.float32``), so that the rates are the JAX package's to the
bit where the operations round alike.  ``multistep`` is MultiStepLR×γ at
epoch milestones, the schedule the trainer uses; the ``warmup_*``
schedules are the capability of the reference's unused
``LearningRateScheduler``.  With ``torch.optim.lr_scheduler.LambdaLR``
take ``lambda s: lr(s) / base``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]
f32 = np.float32


def multistep(base_lr: float, milestones_epochs: Sequence[int], steps_per_epoch: int,
              gamma: float = 0.5) -> Schedule:
    cap = 2 ** 31 - 1  # the JAX package caps its boundaries at int32
    bounds = sorted({min(int(m) * steps_per_epoch, cap) for m in milestones_epochs})

    def lr(step: int) -> float:
        v = f32(base_lr)
        for b in bounds:
            if step >= b:
                v = v * f32(gamma)
        return float(v)

    return lr


def _linear(init: float, end: float, steps: int, count) -> np.float32:
    """optax's ``linear_schedule`` at ``count``."""
    count = min(max(f32(count), f32(0)), f32(steps))
    frac = f32(1) - count / f32(steps)
    return (f32(init) - f32(end)) * frac + f32(end)


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
                  end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 (from base_lr with no warmup) to base_lr, then
    cosine decay to ``end_lr`` at ``total_steps`` (optax's
    ``warmup_cosine_decay_schedule``)."""
    init = base_lr if warmup_steps <= 0 else 0.0
    warm = max(warmup_steps, 1)
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr
    decay_steps = float(total_steps - warm)

    def lr(step: int) -> float:
        if step < warm:
            return float(_linear(init, base_lr, warm, step))
        count = min(f32(step - warm), f32(decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay_steps)))
        return float(f32(base_lr) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))

    return lr


def warmup_stagedecay(base_lr: float, stage_steps: Sequence[int], stage_decay: float,
                      warmup_steps: int = 0) -> Schedule:
    stages = sorted(int(s) for s in stage_steps)

    def lr(step: int) -> float:
        warm = f32(1) if warmup_steps <= 0 else min(f32(step) / f32(warmup_steps), f32(1))
        n_past = sum(step >= s for s in stages)
        return float(f32(base_lr) * warm * f32(stage_decay) ** f32(n_past))

    return lr


def warmup_linear(base_lr: float, total_steps: int, warmup_steps: int = 0) -> Schedule:
    def lr(step: int) -> float:
        warm = f32(1) if warmup_steps <= 0 else min(f32(step) / f32(warmup_steps), f32(1))
        frac = min(max(f32(1) - f32(step) / f32(total_steps), f32(0)), f32(1))
        return float(f32(base_lr) * warm * frac)

    return lr
