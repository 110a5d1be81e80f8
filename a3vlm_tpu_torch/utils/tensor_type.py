"""Parameter dtype policy (counterpart of a3vlm_tpu/utils/tensor_type.py)."""

from __future__ import annotations

import torch

from a3vlm_tpu_torch.quant import QuantizedWeight, tree_map


def mixed_precision_policy(params: dict, trainable_mask: dict,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> dict:
    """Trainable float leaves become float32 masters and frozen ones
    ``compute_dtype`` (tensor_type.py:40). Packed ``QuantizedWeight`` bases
    keep their int8 payload and float32 group scales; integer leaves are
    untouched. Returns a new tree; each leaf is cast where its dtype
    changes, so the old leaf can be freed."""

    def cast(p, trainable):
        if isinstance(p, QuantizedWeight) or not p.is_floating_point():
            return p
        return p.to(torch.float32 if trainable else compute_dtype)

    return tree_map(cast, params, trainable_mask)
