"""The train step (counterpart of a3vlm_tpu/train/step.py).

- The parameter tree splits into a trainable and a frozen part
  (``partition_params``); only the trainable leaves are differentiated, and
  only they carry optimizer state. Frozen leaves may be packed int4
  ``QuantizedWeight`` bases (QLoRA).
- Gradient accumulation averages loss and gradients over the leading
  microbatch axis of the batch.
- The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written
  out in float32 with the same operations in the same order: the clip
  scales by ``max / norm`` only when the norm is not below the maximum (no
  epsilon), AdamW's weight decay applies to leaves with more than one
  dimension, and the learning-rate schedule is read at the count of
  updates made before this one.
- Unlike the JAX step, which returns new arrays, the update is IN PLACE:
  the trainable leaves of ``state.params`` and the moments are updated in
  their own storage, so a step holds no second copy of either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import torch

from a3vlm_tpu_torch.quant import tree_map

Schedule = Callable[[int], float]


def tree_leaves(tree: Any) -> list:
    """Leaves of a tree of dicts and lists, dict keys in sorted order (the
    order JAX flattens them in); ``None`` holes are skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """Inverse of ``tree_leaves``: ``like``'s structure with its non-None
    leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


def partition_params(params: Any, mask: Any) -> tuple[Any, Any]:
    """(trainable, frozen) trees of ``params``' structure with ``None`` at
    the holes (step.py:59)."""
    trainable = tree_map(lambda p, m: p if m else None, params, mask)
    frozen = tree_map(lambda p, m: None if m else p, params, mask)
    return trainable, frozen


def combine_params(trainable: Any, frozen: Any) -> Any:
    """Inverse of ``partition_params``; a ``frozen`` of None (nothing
    frozen) gives ``trainable`` back."""
    if frozen is None:
        return trainable
    if isinstance(trainable, dict):
        return {k: combine_params(v, frozen[k]) for k, v in trainable.items()}
    if isinstance(trainable, (list, tuple)):
        return type(trainable)(combine_params(v, f)
                               for v, f in zip(trainable, frozen))
    return frozen if trainable is None else trainable


def global_norm(leaves: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves))


@dataclass
class AdamWState:
    count: int  # updates made so far
    mu: Any
    nu: Any


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(...,
    mask=ndim > 1))`` (step.py:88), updating parameters in place."""

    def __init__(self, learning_rate: Union[float, Schedule], *,
                 max_grad_norm: float = 8.0, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Any) -> AdamWState:
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> tuple[AdamWState, torch.Tensor]:
        """One update of ``params`` (and of ``state``'s moments) in place;
        returns the state with the count advanced and the gradients'
        global norm before clipping."""
        g_leaves = tree_leaves(grads)
        g_norm = global_norm(g_leaves)
        clip = ~(g_norm < self.max_grad_norm)
        count = state.count + 1
        f32 = dict(dtype=torch.float32, device=g_norm.device)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** count
        bc2 = 1 - torch.tensor(self.b2, **f32) ** count
        step_size = torch.tensor(-self.lr_at(state.count), **f32)
        for g, p, mu, nu in zip(g_leaves, tree_leaves(params),
                                tree_leaves(state.mu), tree_leaves(state.nu)):
            g = torch.where(clip, g / g_norm * self.max_grad_norm, g)
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if p.dim() > 1:
                u = u + self.weight_decay * p
            p.add_(step_size * u)
        return AdamWState(count, state.mu, state.nu), g_norm


def make_optimizer(learning_rate: Union[float, Schedule], *,
                   max_grad_norm: float = 8.0, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.95) -> AdamW:
    """AdamW with a global-norm clip (step.py:88): clip 8 and wd 0 are the
    training recipe's defaults."""
    return AdamW(learning_rate, max_grad_norm=max_grad_norm,
                 weight_decay=weight_decay, b1=b1, b2=b2)


@dataclass
class TrainState:
    params: Any
    opt_state: AdamWState
    step: int

    @classmethod
    def create(cls, params: Any, optimizer: AdamW,
               trainable_mask: Optional[Any] = None) -> "TrainState":
        """Optimizer state over the trainable leaves only."""
        opt_params = (partition_params(params, trainable_mask)[0]
                      if trainable_mask is not None else params)
        return cls(params, optimizer.init(opt_params), 0)


def value_and_grad(loss_fn: Callable, trainable: Any, frozen: Any,
                   batch: dict) -> tuple[torch.Tensor, Any]:
    """Loss and its gradient with respect to every trainable leaf (zeros
    for a leaf the loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(trainable)]
    req = tree_unflatten(trainable, leaves)
    with torch.enable_grad():
        loss = loss_fn(combine_params(req, frozen), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(trainable, grads)


def accumulated_value_and_grad(loss_fn: Callable, trainable: Any,
                               frozen: Any, batch: dict,
                               accum_steps: int = 1
                               ) -> tuple[torch.Tensor, Any]:
    """``value_and_grad`` averaged over the leading microbatch axis of
    every batch entry when ``accum_steps > 1`` (step.py:155-174)."""
    if accum_steps == 1:
        return value_and_grad(loss_fn, trainable, frozen, batch)
    loss_sum, grad_sum = None, None
    for a in range(accum_steps):
        loss, grads = value_and_grad(loss_fn, trainable, frozen,
                                     {k: v[a] for k, v in batch.items()})
        if grad_sum is None:
            loss_sum, grad_sum = loss, tree_leaves(grads)
        else:
            loss_sum = loss_sum + loss
            for acc, g in zip(grad_sum, tree_leaves(grads)):
                acc.add_(g)
    return (loss_sum / accum_steps,
            tree_unflatten(trainable, [g / accum_steps for g in grad_sum]))


def make_train_step(loss_fn: Callable, optimizer: AdamW,
                    accum_steps: int = 1,
                    trainable_mask: Optional[Any] = None) -> Callable:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``
    (step.py:124). ``loss_fn(params, batch)`` returns a scalar; batch
    entries carry a leading [accum_steps] axis when accum_steps > 1. With
    ``trainable_mask`` (True = trainable) only that partition is
    differentiated and updated; ``TrainState.create`` must be given the
    same mask. The grad norm is taken before clipping."""

    def step(state: TrainState, batch: dict):
        if trainable_mask is not None:
            trainable, frozen = partition_params(state.params, trainable_mask)
        else:
            trainable, frozen = state.params, None
        loss, grads = accumulated_value_and_grad(loss_fn, trainable, frozen,
                                                 batch, accum_steps)
        opt_state, grad_norm = optimizer.update(grads, state.opt_state,
                                                trainable)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": grad_norm})

    return step
