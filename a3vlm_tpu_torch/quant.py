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
    """A quantized weight (quant.py:32).
    ``bits=4``: packed ``q`` [*, Kpad/2, N] int8, ``scale``
    [*, Kpad/group, N] float32, and the true input dim ``in_dim``.
    ``bits=8``: ``q`` [*, K, N] int8 and ``scale`` [*, 1, N] float32;
    ``group`` and ``in_dim`` are 0, as in the JAX package.

    ``k_chunks > 1`` (int4 only) is the CHUNK-PACKED layout of a
    row-parallel weight: the padded input dim in ``k_chunks`` equal chunks,
    each split-half packed on its own, ``q`` [*, k_chunks, Kc/2, N] and
    ``scale`` [*, k_chunks, Kc/group, N]. A run of whole chunks is then
    the ordinary packing of that K range, which is what lets a rank hold
    its rows of the weight."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int = 4,
                 group: int = GROUP_SIZE, in_dim: int = 0,
                 k_chunks: int = 1):
        if bits not in (4, 8):
            raise ValueError(f"bits={bits}: want 4 or 8")
        self.q = q
        self.scale = scale
        self.bits = bits
        self.group = group
        self.in_dim = in_dim
        self.k_chunks = k_chunks

    def layer(self, i: int) -> "QuantizedWeight":
        """The i-th slice of a weight stacked on a leading layer axis."""
        return QuantizedWeight(self.q[i], self.scale[i], self.bits,
                               self.group, self.in_dim, self.k_chunks)

    def chunk(self, i: int) -> "QuantizedWeight":
        """Chunk i of a chunk-packed weight, as an ordinary int4 weight of
        its Kc input rows."""
        halfc = self.q.shape[-2]
        return QuantizedWeight(self.q[..., i, :, :], self.scale[..., i, :, :],
                               4, self.group, 2 * halfc)


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


def int4_chunked_geometry(in_dim: int, k_chunks: int):
    """(padded_in_dim, group) of a CHUNK-PACKED int4 weight, or None where
    the dim cannot chunk within 12.5% of zero padding (quant.py:138): every
    chunk a multiple of 512 rows, group 32."""
    unit = 512 * k_chunks
    pad_in = -(-in_dim // unit) * unit
    if pad_in > 1.125 * in_dim:
        return None
    return pad_in, 32


def _quantize_leaf_int4(w: torch.Tensor, k_chunks: int = 1
                        ) -> QuantizedWeight:
    """Quantize ``w`` [*, in, out] in its own dtype, as the JAX package
    does on the host (quant.py:151): per-group absmax / 7, round half to
    even, clip to [-7, 7], split-half pack; with ``k_chunks > 1`` in the
    chunk-packed layout (``int4_chunked_geometry``), each chunk packed on
    its own. The values depend on (padded dim, group) only."""
    *lead, in_dim, out_dim = w.shape
    if in_dim % 2:
        raise ValueError("int4 packing needs an even input dim")
    if k_chunks > 1:
        geo = int4_chunked_geometry(in_dim, k_chunks)
        if geo is None:
            raise ValueError(f"in_dim {in_dim} does not chunk {k_chunks} "
                             "ways")
        pad_in, g = geo
    else:
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
    if k_chunks > 1:
        Kc = pad_in // k_chunks
        qc = q.reshape(*lead, k_chunks, Kc, out_dim)
        packed = ((qc[..., : Kc // 2, :] & 0x0F)
                  | ((qc[..., Kc // 2:, :] & 0x0F) << 4))
        return QuantizedWeight(
            packed.to(torch.int8).contiguous(),
            scale.reshape(*lead, k_chunks, Kc // g, out_dim).contiguous(),
            bits=4, group=g, in_dim=in_dim, k_chunks=k_chunks)
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
    if leaf.k_chunks > 1:  # [*, c, Kc, N] -> [*, Kpad, N]
        *lead, c, Kc, out_dim = q.shape
        q = q.reshape(*lead, c * Kc, out_dim)
        leaf = QuantizedWeight(q, leaf.scale.reshape(*lead, -1, out_dim),
                               4, leaf.group, leaf.in_dim)
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


# the ffn pairs whose hidden dim pads together for tensor parallelism
# (quant.py:249-256): gate / up pad their output dim, down its input dim
_TP_PAD_OUT = {"w1", "w3", "dense_h_to_4h"}
_TP_PAD_IN = {"w2", "dense_4h_to_h"}
# the row-parallel weights (fairscale RowParallelLinear), chunk-packed
# under ``row_parallel``
_ROW_PARALLEL = {"wo", "w2", "dense_4h_to_h"}


def quantize_params(params: dict, bits: int = 4,
                    blocklist: Sequence[str] = (), tp_align: int = 0,
                    row_parallel: int = 0) -> dict:
    """Quantize linear ``weight`` leaves outside blocklisted top-level
    subtrees (quant.py:260) to int4 or int8: embeddings, norms and biases
    stay dense, and under ``bits=4`` a weight with an odd input dim becomes
    int8 (it cannot be packed two rows to a byte).

    ``tp_align`` (model_parallel_size * 128) zero-pads the ffn hidden dim
    to its multiple, so the gate / up outputs split into lane-aligned
    shards; the padded columns are exact zeros, so the forward is the
    unpadded one. ``row_parallel`` (model_parallel_size, int4 only)
    chunk-packs wo / w2 / dense_4h_to_h into that many chunks, widening the
    ffn pad unit to 512 * row_parallel; a weight that cannot chunk within
    the padding budget stays as it is, column-parallel (quant.py:287-289).

    Works IN PLACE on the containers of ``params`` and returns it: each
    dense leaf is replaced, and so can be freed, as soon as its packed form
    exists, so a model never holds its dense and packed decoder at once."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: want 4 or 8")
    ffn_align = tp_align
    if row_parallel > 1 and bits == 4:
        ffn_align = max(tp_align, 512 * row_parallel)

    def tp_pad(x, parent):
        if not ffn_align or parent not in (_TP_PAD_OUT | _TP_PAD_IN):
            return x
        dim = -1 if parent in _TP_PAD_OUT else -2
        pad = -x.shape[dim] % ffn_align
        if not pad:
            return x
        return torch.cat([x, x.new_zeros(
            (*x.shape[:-1], pad) if dim == -1
            else (*x.shape[:-2], pad, x.shape[-1]))], dim=dim)

    def walk(node, names):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, x in list(items):
            path = names + ([key] if isinstance(key, str) else [])
            if isinstance(x, (dict, list)):
                walk(x, path)
            elif isinstance(x, torch.Tensor):
                leaf = key if isinstance(key, str) else None
                if x.dim() >= 2 and not _keep_dense(path[:-1], leaf):
                    parent = path[-2] if len(path) > 1 else None
                    x = tp_pad(x, parent)
                    if bits == 8 or x.shape[-2] % 2:
                        node[key] = _quantize_leaf_int8(x)
                    elif (row_parallel > 1 and parent in _ROW_PARALLEL
                          and int4_chunked_geometry(x.shape[-2],
                                                    row_parallel)):
                        node[key] = _quantize_leaf_int4(
                            x, k_chunks=row_parallel)
                    else:
                        node[key] = _quantize_leaf_int4(x)

    for key, sub in params.items():
        if key not in blocklist and isinstance(sub, (dict, list)):
            walk(sub, [key])
    return params


def quantized_partition_specs(dense_specs: Any, params: Any,
                              n_model: int) -> Any:
    """The specs of a (partly) quantized tree (quant.py:382): a
    ``QuantizedWeight`` whose dense spec names "model" shards its output
    dim where N % (n_model * 128) == 0, a chunk-packed one its chunk axis
    where the chunks divide, else it is replicated; each quantized leaf's
    spec is a ``QuantizedWeight`` holding the spec of ``q`` and of
    ``scale``. Dense leaves keep their specs."""
    from a3vlm_tpu_torch.parallel.mesh import MODEL_AXIS, P

    def leaf_fn(qw, spec):
        if not isinstance(qw, QuantizedWeight):
            return spec
        N = qw.q.shape[-1]
        wants = any(a == MODEL_AXIS or (isinstance(a, tuple)
                                        and MODEL_AXIS in a)
                    for a in (spec or ()) if a is not None)
        if qw.k_chunks > 1:
            lead = len(qw.q.shape) - 3
            if wants and n_model > 1 and qw.k_chunks % n_model == 0:
                qs = P(*([None] * lead), MODEL_AXIS, None, None)
            else:
                qs = P(*([None] * (lead + 3)))
            return QuantizedWeight(qs, qs, qw.bits, qw.group, qw.in_dim,
                                   qw.k_chunks)
        lead = len(qw.q.shape) - 2
        if wants and n_model > 1 and N % (n_model * 128) == 0:
            qs = P(*([None] * (lead + 1)), MODEL_AXIS)
        else:
            qs = P(*([None] * (lead + 2)))
        return QuantizedWeight(qs, qs, qw.bits, qw.group, qw.in_dim)

    return _map_specs(leaf_fn, params, dense_specs)


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (a spec is a tuple,
    so it is a leaf here, not a container)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v, specs[i]) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, specs)


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
