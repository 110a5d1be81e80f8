"""Weight bridge: the JAX package's parameter pytree, as numpy, into the
port's parameters, and back (``params_to_numpy``); and a layered decode
cache, as numpy, into the port's ``KVCache`` (``kv_cache_from_numpy``).

The caller turns the JAX tree into numpy (``jax.tree_util.tree_map(
np.asarray, params)``); this module imports no JAX and recognizes a
``QuantizedWeight`` leaf by its attributes. What changes on the way:

- float leaves become ``dtype`` tensors on ``device``; integer leaves keep
  their type; every leaf is copied, never shared with the numpy array;
- a decoder ``"layers"`` subtree stacked on axis 0 becomes a list of
  per-layer dicts (the decode layout of ``llama.unstack_layers``); an
  unstacked tuple of layers becomes a list as it is;
- ``QuantizedWeight`` leaves, int4 or int8, stacked or not, keep ``q``,
  ``scale``, ``bits``, ``group`` and ``in_dim`` as they are; a chunk-packed
  int4 leaf (``k_chunks > 1``, the JAX package's row-parallel layout) is
  repacked to ``k_chunks = 1`` (``repack_chunked_int4``);
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


def _convert(x, key, leaf):
    """``x`` in the port's layout, each tensor made by ``leaf(x, dtype)``
    (``dtype`` the one a float leaf of this place takes); a stacked
    ``"layers"`` subtree becomes a per-layer list, ``None`` if it holds no
    tensor at all (every leaf a hole). ``None`` holes stay."""
    if x is None:
        return None
    if isinstance(x, dict):
        out = {k: _convert(v, k, leaf) for k, v in x.items()}
        if isinstance(x.get("layers"), dict):
            out["layers"] = _unstack_or_none(out["layers"])
        return out
    if isinstance(x, (list, tuple)):
        return [_convert(v, None, leaf) for v in x]
    if _is_quantized(x):
        q, scale = x.q, x.scale
        if getattr(x, "k_chunks", 1) != 1:
            q, scale = repack_chunked_int4(np.asarray(q), np.asarray(scale))
        return QuantizedWeight(
            leaf(q, torch.int8), leaf(scale, torch.float32),
            bits=int(x.bits), group=int(x.group), in_dim=int(x.in_dim),
        )
    t = leaf(x, None)
    if key == "kernel" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    return t


def repack_chunked_int4(q: np.ndarray, scale: np.ndarray):
    """A chunk-packed int4 weight, q [*, c, Kc/2, N] and scale
    [*, c, Kc/group, N] with the split-half pairing inside each chunk, as
    the ``k_chunks = 1`` layout: q [*, Kpad/2, N] pairing row r with row
    r + Kpad/2, scale [*, Kpad/group, N]. The nibbles only move, so the
    dense weight is bit-identical. Within a chunk the low halves' rows come
    before the high halves', which is the natural row order, so the scale
    rows of all chunks in sequence are already in the order wanted."""
    *lead, c, halfc, N = q.shape
    lo = (q << 4).astype(np.int8) >> 4  # sign-extended low nibbles
    hi = q >> 4
    rows = np.concatenate([lo, hi], axis=-2).reshape(*lead, 2 * c * halfc, N)
    half = c * halfc
    packed = (rows[..., :half, :] & 0x0F) | ((rows[..., half:, :] & 0x0F) << 4)
    return packed.astype(np.int8), scale.reshape(*lead, -1, N)


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


def _unstack_or_none(stacked: dict):
    leaves = []
    tree_map(leaves.append, stacked)
    return unstack_layers(stacked) if leaves else None


def params_from_numpy(tree: dict[str, Any],
                      device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """Convert a numpy copy of a JAX parameter tree (any model of the
    slice: the llama decoder alone or the whole llama_ens5 tree, with or
    without a ``"lora"`` adapter tree, whose stacked ``layers`` become
    per-layer lists like the decoder's)."""
    return _convert(tree, None,
                    lambda x, dt: _tensor(x, device, dt or dtype))


def _hwio(t: torch.Tensor, key) -> torch.Tensor:
    t = t.detach()
    if key == "kernel" and t.dim() == 4:
        t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    return t


def _host_leaf(t: torch.Tensor, numpy: bool):
    """A copy of ``t`` on the host: numpy with bf16 as float32, or a tensor
    of ``t``'s dtype."""
    if numpy and t.dtype == torch.bfloat16:
        t = t.float()
    t = t.to("cpu", copy=True)
    return t.numpy() if numpy else t


# The most bytes of one leaf's layers stacked on their device at a time
# before the copy to the host: few copies for small leaves (an adapter's
# 40 layers in one), and no second device copy of a large tree.
STACK_CHUNK_BYTES = 256 << 20


def _stack_host(ts: list, key, numpy: bool):
    """Per-layer trees stacked on a new axis 0 on the host (the inverse of
    ``unstack_layers``), leaf by leaf, each leaf's layers stacked on their
    device in chunks of at most ``STACK_CHUNK_BYTES`` (one layer at least)
    and copied to the host chunk by chunk."""
    first = ts[0]
    if isinstance(first, dict):
        return {k: _stack_host([lp[k] for lp in ts], k, numpy)
                for k in first}
    if first is None:
        return None
    if isinstance(first, QuantizedWeight):
        return SimpleNamespace(
            q=_stack_host([lp.q for lp in ts], None, numpy),
            scale=_stack_host([lp.scale for lp in ts], None, numpy),
            bits=first.bits, group=first.group, in_dim=first.in_dim)
    first = _hwio(first, key)
    dtype = torch.float32 if numpy and first.dtype == torch.bfloat16 \
        else first.dtype
    out = torch.empty((len(ts), *first.shape), dtype=dtype)
    step = max(1, STACK_CHUNK_BYTES
               // max(1, first.numel() * first.element_size()))
    for i in range(0, len(ts), step):
        out[i:i + step].copy_(torch.stack(
            [_hwio(t, key) for t in ts[i:i + step]]))
    return out.numpy() if numpy else out


def _to_host(x, key, stack: bool, numpy: bool):
    """``x`` in the JAX package's layout on the host: conv kernels HWIO,
    int4 and int8 weights as ``SimpleNamespace``; ``stack``: a
    ``"layers"`` list in this subtree stacked on axis 0. ``None`` holes
    stay."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _stack_host(v, None, numpy)
                if stack and k == "layers" and isinstance(v, list)
                else _to_host(v, k, stack, numpy) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_host(v, None, stack, numpy) for v in x]
    if isinstance(x, QuantizedWeight):
        return SimpleNamespace(q=_host_leaf(x.q, numpy),
                               scale=_host_leaf(x.scale, numpy), bits=x.bits,
                               group=x.group, in_dim=x.in_dim)
    return _host_leaf(_hwio(x, key), numpy)


def _host_tree(tree: dict[str, Any], numpy: bool) -> dict[str, Any]:
    return {k: _stack_host(v, None, numpy)
            if k == "layers" and isinstance(v, list)
            else _to_host(v, k, k in ("llama", "lora"), numpy)
            for k, v in tree.items()}


def params_to_numpy(tree: dict[str, Any]) -> dict[str, Any]:
    """The port's tree back in the JAX package's layout, as numpy: the
    ``layers`` lists of the decoder and its adapters (top-level ``llama``
    and ``lora``, or a bare decoder tree's own) stacked on axis 0, conv
    kernels HWIO, bf16 as float32, int4 and int8 weights as objects with
    ``q``/``scale``/``bits``/``group``/``in_dim`` (which
    ``params_from_numpy`` reads back). Other lists of layers (the
    Q-Former's, which are not alike) stay lists, as in the JAX tree. For
    comparing gradients and parameters with the JAX package leaf by
    leaf, and for the export tools."""
    return _host_tree(tree, numpy=True)


def params_to_host(tree: dict[str, Any]) -> dict[str, Any]:
    """``params_to_numpy``'s layout as tensors on the host, each dtype kept
    (bf16 stays bf16) and each leaf a copy: the checkpoint's form. The
    copies are synchronous, so they hold the values of the moment of the
    call. ``None`` holes stay ``None``."""
    return _host_tree(tree, numpy=False)


def params_from_host(tree: dict[str, Any],
                     device: torch.device | str = "cuda") -> dict[str, Any]:
    """The inverse of ``params_to_host``: the port's layout on ``device``,
    each dtype kept. A stacked ``layers`` subtree becomes a per-layer list
    of views into one tensor a leaf; one with no tensor at all (every leaf
    a hole) becomes ``None``."""
    return _convert(tree, None, lambda t, dt: t.to(device))


def kv_cache_from_numpy(k_layers, v_layers,
                        device: torch.device | str = "cuda",
                        dtype: torch.dtype = torch.float32):
    """A layered JAX ``KVCache`` (its ``k`` and ``v`` tuples, every leaf
    turned into numpy) as the port's ``KVCache``. A dense layer
    [B, Hkv, S, D] becomes a ``dtype`` tensor; an int8 layer, a
    ``(qv, scale)`` pair, becomes a ``QuantizedKV`` with the int8 values and
    float32 scales as they are. Every leaf is copied."""
    from a3vlm_tpu_torch.models.llama import KVCache
    from a3vlm_tpu_torch.ops.decode_attention import QuantizedKV

    def layer(x):
        if isinstance(x, (tuple, list)):
            qv, scale = x
            return QuantizedKV(_tensor(qv, device, torch.int8),
                               _tensor(scale, device, torch.float32))
        return _tensor(x, device, dtype)

    return KVCache([layer(x) for x in k_layers], [layer(x) for x in v_layers])
