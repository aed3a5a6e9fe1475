"""LR schedule: per-iteration linear warmup + half-cosine decay
(``rald_tpu/train/schedule.py:12-37``).

``warmup_cosine_schedule`` returns a plain function of the optimizer's
update count, the reference's ``adjust_learning_rate`` with ``epoch = step /
steps_per_epoch``; ``scale_base_lr`` is the effective-batch base-LR rule.
"""
from __future__ import annotations

import math


def scale_base_lr(blr: float, batch_size: int, accum_iter: int, world_size: int) -> float:
    """lr = blr * eff_batch / 256."""
    return float(blr) * batch_size * accum_iter * world_size / 256.0


def warmup_cosine_schedule(lr: float, min_lr: float, warmup_epochs: float, epochs: float,
                           steps_per_epoch: int):
    """``schedule(step) -> lr``: linear warmup over ``warmup_epochs``, then a
    half cosine from ``lr`` down to ``min_lr`` at ``epochs``."""
    lr, min_lr = float(lr), float(min_lr)
    warmup_epochs = float(warmup_epochs)
    denom = max(float(epochs) - warmup_epochs, 1e-8)

    def schedule(step) -> float:
        epoch = float(step) / steps_per_epoch
        if epoch < warmup_epochs:
            return lr * epoch / warmup_epochs
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom))

    return schedule
