"""Weight bridge: the JAX package's parameter pytree, as numpy, into the
port's parameters, and back (``params_to_numpy``).

The caller turns the JAX tree into numpy (``jax.tree_util.tree_map(
np.asarray, params)``); this module imports no JAX and recognizes a
``QuantizedWeight`` leaf by its attributes. What changes on the way:

- float leaves become ``dtype`` tensors on ``device``; integer leaves keep
  their type; every leaf is copied, never shared with the numpy array;
- a decoder ``"layers"`` subtree stacked on axis 0 becomes a list of
  per-layer dicts (the decode layout of ``llama.unstack_layers``); an
  unstacked tuple of layers becomes a list as it is;
- int4 ``QuantizedWeight`` leaves keep ``q``, ``scale``, ``group`` and
  ``in_dim`` as they are (``k_chunks > 1`` is refused);
- conv ``"kernel"`` leaves turn from HWIO into torch's OIHW.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from a3vlm_tpu_torch.quant import QuantizedWeight, tree_map


def _is_quantized(x) -> bool:
    return all(hasattr(x, a) for a in ("q", "scale", "bits", "group",
                                       "in_dim"))


def _tensor(x, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.tensor(arr)
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(x, key, device, dtype):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _convert_child(k, v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_convert(v, None, device, dtype) for v in x]
    if _is_quantized(x):
        if getattr(x, "k_chunks", 1) != 1:
            raise NotImplementedError(
                "chunk-packed int4 (k_chunks > 1) is not bridged yet")
        if x.bits != 4:
            raise NotImplementedError(f"only int4 weights are ported, got "
                                      f"bits={x.bits}")
        return QuantizedWeight(
            _tensor(x.q, device, torch.int8),
            _tensor(x.scale, device, torch.float32),
            bits=4, group=int(x.group), in_dim=int(x.in_dim),
        )
    t = _tensor(x, device, dtype)
    if key == "kernel" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    return t


def _convert_child(key, value, device, dtype):
    out = _convert(value, key, device, dtype)
    if key == "layers" and isinstance(value, dict):
        return unstack_layers(out)
    return out


def unstack_layers(stacked: dict) -> list:
    """Per-layer list of a tree stacked on axis 0 (llama.py:225)."""
    leaves = []
    tree_map(leaves.append, stacked)
    first = leaves[0]
    n = (first.q if isinstance(first, QuantizedWeight) else first).shape[0]
    return [
        tree_map(lambda t, i=i: t.layer(i) if isinstance(t, QuantizedWeight)
                 else t[i], stacked)
        for i in range(n)
    ]


def params_from_numpy(tree: dict[str, Any], device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """Convert a numpy copy of a JAX parameter tree (any model of the
    slice: the llama decoder alone or the whole llama_ens5 tree, with or
    without a ``"lora"`` adapter tree, whose stacked ``layers`` become
    per-layer lists like the decoder's)."""
    return {k: _convert_child(k, v, device, dtype) for k, v in tree.items()}


def _to_numpy(x, key, stack: bool = False):
    """``stack``: turn a ``"layers"`` list in this subtree into arrays
    stacked on axis 0."""
    if x is None:
        return None
    if isinstance(x, dict):
        out = {k: _to_numpy(v, k, stack) for k, v in x.items()}
        if stack and isinstance(x.get("layers"), list):
            out["layers"] = stack_layers(out["layers"])
        return out
    if isinstance(x, (list, tuple)):
        return [_to_numpy(v, None, stack) for v in x]
    if isinstance(x, QuantizedWeight):
        return SimpleNamespace(q=_to_numpy(x.q, None),
                               scale=_to_numpy(x.scale, None), bits=x.bits,
                               group=x.group, in_dim=x.in_dim)
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if key == "kernel" and t.dim() == 4:
        t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    return t.numpy().copy()


def stack_layers(layers: list) -> Any:
    """A list of per-layer numpy trees stacked on a new axis 0 (the inverse
    of ``unstack_layers``)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    if first is None:
        return None
    if isinstance(first, SimpleNamespace):
        return SimpleNamespace(
            q=np.stack([lp.q for lp in layers]),
            scale=np.stack([lp.scale for lp in layers]), bits=first.bits,
            group=first.group, in_dim=first.in_dim)
    return np.stack(layers)


def params_to_numpy(tree: dict[str, Any]) -> dict[str, Any]:
    """The port's tree back in the JAX package's layout, as numpy: the
    ``layers`` lists of the decoder and its adapters (top-level ``llama``
    and ``lora``, or a bare decoder tree's own) stacked on axis 0, conv
    kernels HWIO, bf16 as float32, int4 weights as objects with
    ``q``/``scale``/``bits``/``group``/``in_dim`` (which
    ``params_from_numpy`` reads back). Other lists of layers (the
    Q-Former's, which are not alike) stay lists, as in the JAX tree. For
    comparing gradients and parameters with the JAX package leaf by
    leaf."""
    out = {k: _to_numpy(v, k, stack=k in ("llama", "lora"))
           for k, v in tree.items()}
    if isinstance(tree.get("layers"), list):
        out["layers"] = stack_layers(out["layers"])
    return out
