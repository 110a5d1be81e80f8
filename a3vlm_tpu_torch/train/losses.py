"""Training loss (counterpart of a3vlm_tpu/train/losses.py): next-token
cross-entropy with label id 0 ignored, padded vocab columns masked, and
exactly zero on a batch whose labels are all ignored."""

from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    vocab_size: int | None = None) -> torch.Tensor:
    """logits [B, S, V] (text positions), labels [B, S] int (0 = ignore);
    ``vocab_size`` is the true vocab when V is padded (losses.py:21).
    Returns the float32 mean over valid positions."""
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logits = logits[:, :-1, :]
    labels = labels[:, 1:]
    valid = labels != 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    n_valid = valid.sum()
    loss = -torch.where(valid, token_ll, torch.zeros_like(token_ll)).sum()
    return torch.where(n_valid > 0, loss / n_valid.clamp_min(1),
                       torch.zeros_like(loss))
