"""Cosine learning rate with linear warmup (counterpart of
a3vlm_tpu/train/lr_sched.py), as plain Python."""

from __future__ import annotations

import math
from typing import Callable


def cosine_lr(it: float, *, lr: float, min_lr: float, warmup_iters: float,
              total_iters: float) -> float:
    """LR at (fractional) iteration ``it`` (lr_sched.py:9)."""
    if warmup_iters > 0 and it < warmup_iters:
        return lr * it / warmup_iters
    progress = (it - warmup_iters) / max(total_iters - warmup_iters, 1e-8)
    return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))


def make_epoch_schedule(*, lr: float, min_lr: float, warmup_epochs: float,
                        epochs: float, updates_per_epoch: int,
                        start_epoch: int = 0) -> Callable[[int], float]:
    """Update count -> LR over the epoch fraction (lr_sched.py:24): the
    count is that of the updates made before this one."""

    def schedule(count: int) -> float:
        frac = start_epoch + count / max(updates_per_epoch, 1)
        if warmup_epochs > 0 and frac < warmup_epochs:
            return lr * frac / max(warmup_epochs, 1e-8)
        progress = (frac - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi
                                                              * progress))

    return schedule


def adjust_learning_rate_epoch(epoch_frac: float, *, lr: float,
                               min_lr: float, warmup_epochs: float,
                               epochs: float) -> float:
    """Epoch-fraction variant (lr_sched.py:45)."""
    return cosine_lr(epoch_frac, lr=lr, min_lr=min_lr,
                     warmup_iters=warmup_epochs, total_iters=epochs)
