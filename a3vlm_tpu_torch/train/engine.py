"""One-epoch training loop (counterpart of a3vlm_tpu/train/engine.py):
the schedule's learning rate logged per update, metrics through
``MetricLogger`` and TensorBoard (the effective-epoch x 1000 x-axis), a
stop on a non-finite loss (engine.py:54-58), and in-epoch checkpointing
every ``save_iteration_interval`` updates (engine.py:66-73)."""

from __future__ import annotations

import math
from typing import Callable, Optional

from a3vlm_tpu_torch.train.lr_sched import adjust_learning_rate_epoch
from a3vlm_tpu_torch.utils.logging import MetricLogger


def train_one_epoch(train_step: Callable, state, loader, epoch: int, *,
                    lr: float, min_lr: float, warmup_epochs: float,
                    epochs: float, print_freq: int = 10, tb_logger=None,
                    save_fn: Optional[Callable] = None,
                    save_iteration_interval: int = 5000):
    """``train_step(state, batch) -> (state, metrics)`` embeds the schedule
    (``make_epoch_schedule``); the learning rate computed here is the same
    value, for the log. ``save_fn(state, epoch, it)`` saves in the epoch.
    ``it`` counts the batches this call takes, from 0, and ``len(loader)``
    the batches of a whole epoch, as in the JAX loop: after a resume in
    the middle of an epoch both stay so. Returns (state, {meter: global
    average})."""
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
        if tb_logger is not None:
            x = int(epoch_frac * 1000)
            tb_logger.add_scalar("c_train_loss", loss, x)
            tb_logger.add_scalar("lr", cur_lr, x)
        if (save_fn is not None and (it + 1) % save_iteration_interval == 0
                and it + 1 != n_iters):
            save_fn(state, epoch, it + 1)
    print(f"Averaged stats: {metric_logger}")
    return state, {k: m.global_avg for k, m in metric_logger.meters.items()}
