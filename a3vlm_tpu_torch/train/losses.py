"""Training loss (counterpart of a3vlm_tpu/train/losses.py): next-token
cross-entropy with label id 0 ignored, padded vocab columns masked, and
exactly zero on a batch whose labels are all ignored. On a mesh whose data
ranks each hold a share of the batch's rows the loss is the mean over the
whole batch's valid tokens, as the JAX loss of a batch split over "data"
is: not a mean of the ranks' means."""

from __future__ import annotations

import torch

from a3vlm_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce, reduce_from


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    vocab_size: int | None = None,
                    data_mesh=None) -> torch.Tensor:
    """logits [B, S, V] (text positions), labels [B, S] int (0 = ignore);
    ``vocab_size`` is the true vocab when V is padded (losses.py:21).
    Returns the float32 mean over valid positions. ``data_mesh``: the mesh
    whose "data" ranks each hold a share of the rows; the sum of the
    token log-likelihoods and the count of valid labels are each summed
    over "data" before the division (the sum's gradient passes to each
    rank's own tokens as it is)."""
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
    if data_mesh is not None and data_mesh.dp_size > 1:
        loss = reduce_from(loss, data_mesh, DATA_AXIS)
        n_valid = all_reduce(n_valid, data_mesh, DATA_AXIS)
    return torch.where(n_valid > 0, loss / n_valid.clamp_min(1),
                       torch.zeros_like(loss))
