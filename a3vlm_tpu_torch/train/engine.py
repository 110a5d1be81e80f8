"""One-epoch training loop (counterpart of a3vlm_tpu/train/engine.py):
the schedule's learning rate logged per update, metrics through
``MetricLogger``, and a stop on a non-finite loss (engine.py:54-58).
In-epoch checkpointing waits for the checkpoint manager."""

from __future__ import annotations

import math
from typing import Callable

from a3vlm_tpu_torch.train.lr_sched import adjust_learning_rate_epoch
from a3vlm_tpu_torch.utils.logging import MetricLogger


def train_one_epoch(train_step: Callable, state, loader, epoch: int, *,
                    lr: float, min_lr: float, warmup_epochs: float,
                    epochs: float, print_freq: int = 10):
    """``train_step(state, batch) -> (state, metrics)`` embeds the schedule
    (``make_epoch_schedule``); the learning rate computed here is the same
    value, for the log. Returns (state, {meter: global average})."""
    metric_logger = MetricLogger()
    n_iters = len(loader)
    for it, batch in enumerate(metric_logger.log_every(
            loader, print_freq, f"Epoch: [{epoch}]", total=n_iters)):
        epoch_frac = epoch + it / max(n_iters, 1)
        cur_lr = adjust_learning_rate_epoch(
            epoch_frac, lr=lr, min_lr=min_lr, warmup_epochs=warmup_epochs,
            epochs=epochs)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(
                f"loss is {loss} at epoch {epoch} iter {it}, stopping "
                "training")
        metric_logger.update(closs=loss, lr=cur_lr,
                             grad_norm=float(metrics["grad_norm"]))
    print(f"Averaged stats: {metric_logger}")
    return state, {k: m.global_avg for k, m in metric_logger.meters.items()}
