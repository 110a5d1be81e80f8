"""Weight-only quantization (counterpart of a3vlm_tpu/quant.py).

int8: symmetric, one float32 scale per output channel. int4: group-wise
symmetric over the input dim, packed SPLIT-HALF: byte row ``r`` of ``q``
holds weight row ``r`` in its low nibble and row ``r + K/2`` in its high
nibble. Inputs of 1024 rows or more are zero-padded so K blocks align
(``int4_geometry``). Values and packing are byte-identical to the JAX
package's, so the same quantized weights serve both."""

from __future__ import annotations

from typing import Any, Sequence

import torch

GROUP_SIZE = 64
KERNEL_K_ALIGN = 1024


class QuantizedWeight:
    """A quantized weight (quant.py:32, with ``k_chunks == 1``).
    ``bits=4``: packed ``q`` [*, Kpad/2, N] int8, ``scale``
    [*, Kpad/group, N] float32, and the true input dim ``in_dim``.
    ``bits=8``: ``q`` [*, K, N] int8 and ``scale`` [*, 1, N] float32;
    ``group`` and ``in_dim`` are 0, as in the JAX package."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int = 4,
                 group: int = GROUP_SIZE, in_dim: int = 0):
        if bits not in (4, 8):
            raise ValueError(f"bits={bits}: want 4 or 8")
        self.q = q
        self.scale = scale
        self.bits = bits
        self.group = group
        self.in_dim = in_dim

    def layer(self, i: int) -> "QuantizedWeight":
        """The i-th slice of a weight stacked on a leading layer axis."""
        return QuantizedWeight(self.q[i], self.scale[i], self.bits,
                               self.group, self.in_dim)


class LoraWeight:
    """A base weight (dense tensor or ``QuantizedWeight``) with a rank-r
    adapter: the effective weight is ``w + a @ b`` (quant.py:72). ``qmat``
    runs the base product in its own form and adds ``(x @ a) @ b``."""

    def __init__(self, w, a: torch.Tensor, b: torch.Tensor):
        self.w = w
        self.a = a
        self.b = b


def freeze_quantized_mask(params: dict, mask: dict) -> dict:
    """The trainable mask with False at every ``QuantizedWeight``
    (quant.py:354): packed bases are frozen by construction."""
    return tree_map(
        lambda p, m: False if isinstance(p, QuantizedWeight) else m,
        params, mask)


def int4_geometry(in_dim: int) -> tuple[int, int]:
    """(padded_in_dim, group) for an int4 weight (quant.py:120)."""
    pad_in = in_dim
    if in_dim >= KERNEL_K_ALIGN:
        pad_in = -(-in_dim // KERNEL_K_ALIGN) * KERNEL_K_ALIGN
        pad4096 = -(-in_dim // 4096) * 4096
        if pad4096 <= 1.125 * in_dim:
            pad_in = max(pad_in, pad4096)
    g = min(GROUP_SIZE, pad_in)
    while pad_in % g or (pad_in // 2) % g:
        g //= 2
    return pad_in, g


def _quantize_leaf_int8(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel int8 of ``w`` [*, in, out] in its own dtype
    (quant.py:106): scale [*, 1, out] = max(absmax over in, 1e-8) / 127,
    round half to even, clip to [-127, 127]. The divisor is a tensor: on a
    CUDA tensor a Python divisor becomes a product with its rounded
    reciprocal, which is an ulp off the quotient the JAX package takes."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8)
    scale = scale / torch.full_like(scale, 127.0)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(q.contiguous(),
                           scale.to(torch.float32).contiguous(), bits=8,
                           group=0, in_dim=0)


def _quantize_leaf_int4(w: torch.Tensor) -> QuantizedWeight:
    """Quantize ``w`` [*, in, out] in its own dtype, as the JAX package
    does on the host (quant.py:151): per-group absmax / 7, round half to
    even, clip to [-7, 7], split-half pack."""
    *lead, in_dim, out_dim = w.shape
    if in_dim % 2:
        raise ValueError("int4 packing needs an even input dim")
    pad_in, g = int4_geometry(in_dim)
    if pad_in != in_dim:
        w = torch.cat([w, w.new_zeros((*lead, pad_in - in_dim, out_dim))],
                      dim=-2)
    wg = w.reshape(*lead, pad_in // g, g, out_dim)
    scale = wg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8)
    scale = scale / torch.full_like(scale, 7.0)  # a tensor: see int8 above
    q = torch.round(wg / scale).clamp(-7, 7).to(torch.int8)
    q = q.reshape(*lead, pad_in, out_dim)
    scale = scale.reshape(*lead, pad_in // g, out_dim).to(torch.float32)
    half = pad_in // 2
    packed = (q[..., :half, :] & 0x0F) | ((q[..., half:, :] & 0x0F) << 4)
    return QuantizedWeight(packed.to(torch.int8).contiguous(),
                           scale.contiguous(), bits=4, group=g,
                           in_dim=in_dim)


def unpack_int4(packed: torch.Tensor):
    """Split-half packed bytes -> (lo, hi) sign-extended int8 halves."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    return lo.to(torch.int8), hi.to(torch.int8)


def _dequantize_leaf(leaf: QuantizedWeight,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense [*, in_dim, N] weight (quant.py:222)."""
    if leaf.bits == 8:
        return (leaf.q.float() * leaf.scale).to(dtype)
    lo, hi = unpack_int4(leaf.q)
    q = torch.cat([lo, hi], dim=-2)
    *lead, pad_in, out_dim = q.shape
    g = leaf.group
    w = (q.reshape(*lead, pad_in // g, g, out_dim).float()
         * leaf.scale[..., :, None, :])
    return w.reshape(*lead, pad_in, out_dim)[..., :leaf.in_dim, :].to(dtype)


def _keep_dense(names: Sequence[str], leaf_name) -> bool:
    if leaf_name != "weight":
        return True  # biases, gammas, ...
    return any(
        n in ("tok_embeddings", "word_embeddings") or "norm" in n
        or n.startswith("ln")
        for n in names
    )


def quantize_params(params: dict, bits: int = 4,
                    blocklist: Sequence[str] = ()) -> dict:
    """Quantize linear ``weight`` leaves outside blocklisted top-level
    subtrees (quant.py:260) to int4 or int8: embeddings, norms and biases
    stay dense, and under ``bits=4`` a weight with an odd input dim becomes
    int8 (it cannot be packed two rows to a byte).

    Works IN PLACE on the containers of ``params`` and returns it: each
    dense leaf is replaced, and so can be freed, as soon as its packed form
    exists, so a model never holds its dense and packed decoder at once."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: want 4 or 8")

    def walk(node, names):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, x in list(items):
            path = names + ([key] if isinstance(key, str) else [])
            if isinstance(x, (dict, list)):
                walk(x, path)
            elif isinstance(x, torch.Tensor):
                leaf = key if isinstance(key, str) else None
                if x.dim() >= 2 and not _keep_dense(path[:-1], leaf):
                    if bits == 8 or x.shape[-2] % 2:
                        node[key] = _quantize_leaf_int8(x)
                    else:
                        node[key] = _quantize_leaf_int4(x)

    for key, sub in params.items():
        if key not in blocklist and isinstance(sub, (dict, list)):
            walk(sub, [key])
    return params


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor or QuantizedWeight leaf of a tree of
    dicts and lists (``None`` stays ``None``); with ``rest``, trees of the
    same structure whose matching leaves are passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)
