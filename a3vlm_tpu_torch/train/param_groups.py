"""Layer-wise learning-rate decay (counterpart of
a3vlm_tpu/train/param_groups.py; the reference's util/param_group.py,
``lr_scale = decay^(n_layers - layer)``): a tree of per-leaf scales that
``AdamW(update_scales=...)`` multiplies into each update, in place of
optimizer parameter groups."""

from __future__ import annotations

from typing import Any

import torch

from a3vlm_tpu_torch.quant import tree_map

_STEM_KEYS = ("tok_embeddings", "patch_embed", "class_embedding",
              "positional_embedding")


def layerwise_scale_tree(params: Any, layer_decay: float,
                         layers_key: str = "layers") -> Any:
    """A tree of float32 scales of ``params``' structure
    (param_groups.py:14-38). Under ``layers_key``: a list of L per-layer
    trees (the port's layout of a stacked decoder) gives layer l the scale
    ``decay^(L - 1 - l)``; a tensor stacked on axis 0 gets that vector,
    shaped [L, 1, ...] to broadcast, as in the JAX tree. The stem and
    embeddings get ``decay^24``; every other leaf 1. (A list under
    ``layers_key`` is always per-layer here; the JAX function reads a
    list's leaves as stacked ones, which the Q-Former's are not.)"""

    def per_layer(L):
        return layer_decay ** (L - 1 - torch.arange(L, dtype=torch.float32))

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + [k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if keys and keys[-1] == layers_key:
                scales = per_layer(len(node))
                return [tree_map(lambda _, s=s: s.clone(), v)
                        for v, s in zip(node, scales)]
            return [walk(v, keys) for v in node]
        if node is None:
            return None
        if layers_key in keys:
            L = node.shape[0]
            return per_layer(L).reshape((L,) + (1,) * (node.dim() - 1))
        if any(k in _STEM_KEYS for k in keys):
            return torch.tensor(layer_decay, dtype=torch.float32) ** 24
        return torch.tensor(1.0, dtype=torch.float32)

    return walk(params, [])
