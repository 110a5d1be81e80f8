"""Tensor-parallel pieces of the decoders: sharded weights and the
collectives around their products (what XLA inserts for the JAX package
from the params' shardings and the ``custom_partitioning`` wrappers of
ops/quant_matmul.py and ops/decode_attention.py).

A decoder linear split over "model" is a ``Shard``: this rank's block of
the weight and which dimension it split.

- ``column``: the first linear of a pair (wq / wk / wv, w1 / w3,
  dense_h_to_4h). Its output is this rank's share of the columns: the
  kernel on the local N of a column shard; a replicated weight computes
  every column and keeps this rank's share.
- ``row``: the second linear (wo, w2, dense_4h_to_h), from this rank's
  share of its input to the whole output on every rank. A row shard (a
  dense weight's rows, or a chunk-packed int4 weight's chunks) runs the
  kernel on the local K and all-reduces the partial in float32, cast once
  (``_spmd_int4_rowp``, quant_matmul.py:870-879); a column shard (the
  all-column form of a quantized tree) gathers the input, runs on the
  local N and gathers the output; a replicated weight gathers the input.
- ``embed`` gathers a dim-sharded table's columns; ``head`` gathers the
  logits' columns. Every rank then holds the same bytes, so greedy and
  sampled picks agree without a broadcast.

In training the collectives carry gradients (``parallel/mesh.py``'s
differentiable forms) so that a replicated tensor's gradient is the whole
one, the same bytes on every rank, and a split tensor's this rank's block
of it: the input of column products takes its gradient summed over
"model" (``copy_to``, once for the products that share it); a row
shard's partial sum passes its gradient as it is (``reduce_from``); a
gather consumed the same on every rank (the logits, the embedding's
columns, the all-column output) gives back this rank's slice, one
consumed by a product of each rank's own (the all-column input, the
padded-K input) the reduce-scatter. A ``LoraWeight`` over a split base
keeps its adapters split as ``train.lora.lora_partition_specs`` splits
them (a column weight's ``b`` on its output, a row weight's ``a`` on its
input), and its side path takes a collective of its own between its two
products.

Every product under a mesh of more than one rank takes the exact int4 /
int8 kernel whatever the mode flags say: the JAX dispatchers do the same
under more than one device (quant_matmul.py:956-960).

The data axis: ``data_rows`` takes this rank's rows of a batch that divides
over "data" (every row otherwise), ``data_gather`` puts the rows back
together; ``crop_share`` / ``crop_gather`` split the image crops over the
whole mesh (ens5.py:256-259, :306-312).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from a3vlm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_gather,
    copy_to,
    current_mesh,
    gather,
    gather_uneven,
    is_parallel,
    local_slice,
    reduce_from,
    split_range,
)
from a3vlm_tpu_torch.quant import LoraWeight, QuantizedWeight


class Shard:
    """This rank's block of a decoder weight split over "model".

    ``kind``: "col" (output columns [start, stop) of ``full``; an
    embedding table's columns) or "row" (rows [start, stop) of the padded
    input dim ``full``)."""

    def __init__(self, local, kind: str, start: int, stop: int, full: int):
        self.local = local
        self.kind = kind
        self.start = start
        self.stop = stop
        self.full = full

    @property
    def dim(self) -> int:
        """The dimension a dense block splits: the last (columns) or the
        one before it (rows)."""
        return -1 if self.kind == "col" else -2

    def with_local(self, local) -> "Shard":
        """The same block of the same leaf, holding ``local``."""
        return Shard(local, self.kind, self.start, self.stop, self.full)

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This block of ``whole`` (the dense leaf it was cut from)."""
        if whole.shape[self.dim] != self.full:
            raise ValueError(f"a whole leaf of {whole.shape[self.dim]} "
                             f"along its split dim, the block's has "
                             f"{self.full}")
        return whole.narrow(self.dim, self.start,
                            self.stop - self.start).contiguous()


def gather_shard(s: Shard, mesh: Mesh) -> torch.Tensor:
    """The whole dense leaf of a ``Shard``, every rank's block gathered
    over "model" (every rank of the group calls it)."""
    if isinstance(s.local, QuantizedWeight):
        raise ValueError("a packed base is frozen: it is not gathered")
    return all_gather(s.local.contiguous(), mesh, s.dim, MODEL_AXIS)


def _model_axis(spec) -> Optional[int]:
    """The dim ``spec`` splits over "model", or None."""
    for i, a in enumerate(spec or ()):
        if a == MODEL_AXIS or (isinstance(a, tuple) and MODEL_AXIS in a):
            return i
    return None


def _shard_quantized(qw: QuantizedWeight, spec: QuantizedWeight, mesh: Mesh):
    q = qw.q.to(mesh.device)
    scale = qw.scale.to(mesh.device)
    dim = _model_axis(spec.q)
    if dim is None or mesh.mp_size == 1:
        return QuantizedWeight(q, scale, qw.bits, qw.group, qw.in_dim,
                               qw.k_chunks)
    ql = local_slice(q, spec.q, mesh)
    sl = local_slice(scale, spec.scale, mesh)
    if qw.k_chunks > 1:  # the chunk axis: rows of the padded K
        c = qw.k_chunks
        a, b = split_range(c, mesh.mp_size, mesh.model_index)
        kc = 2 * qw.q.shape[-2]
        if b - a == 1:
            local = QuantizedWeight(ql[..., 0, :, :], sl[..., 0, :, :], 4,
                                    qw.group, kc)
        else:
            local = QuantizedWeight(ql, sl, 4, qw.group, (b - a) * kc,
                                    b - a)
        return Shard(local, "row", a * kc, b * kc, c * kc)
    N = qw.q.shape[-1]
    a, b = split_range(N, mesh.mp_size, mesh.model_index)
    return Shard(QuantizedWeight(ql, sl, qw.bits, qw.group, qw.in_dim),
                 "col", a, b, N)


def shard_tree(params, mesh: Mesh, specs):
    """``shard_params``: this rank's part of a full tree under ``specs``."""
    if isinstance(params, dict):
        return {k: shard_tree(v, mesh, specs[k]) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_tree(v, mesh, specs[i]) for i, v in enumerate(params)]
    if params is None:
        return None
    if isinstance(params, QuantizedWeight):
        if not isinstance(specs, QuantizedWeight):
            raise ValueError("a quantized leaf needs quantized specs "
                             "(quantized_partition_specs)")
        return _shard_quantized(params, specs, mesh)
    x = params.to(mesh.device)
    local = local_slice(x, specs, mesh)
    dim = _model_axis(specs)
    if dim is None or mesh.mp_size == 1:
        return local
    a, b = split_range(x.shape[dim], mesh.mp_size, mesh.model_index)
    return Shard(local, "col" if dim == x.dim() - 1 else "row", a, b,
                 x.shape[dim])


def local_weight(w):
    """The weight this rank multiplies by (a ``Shard``'s block; a
    ``LoraWeight`` of the blocks of its base and adapters)."""
    if isinstance(w, LoraWeight):
        return LoraWeight(local_weight(w.w), local_weight(w.a),
                          local_weight(w.b))
    return w.local if isinstance(w, Shard) else w


def base_weight(w):
    """The base of a ``LoraWeight`` (``w`` itself otherwise): a ``Shard``
    inside one says how the linear splits."""
    return w.w if isinstance(w, LoraWeight) else w


def _mesh() -> Optional[Mesh]:
    m = current_mesh()
    return m if is_parallel(m) else None


def _mm(x, w, impl: str, mesh: Optional[Mesh]):
    from a3vlm_tpu_torch.ops.quant_matmul import qmat, sharded_matmul

    w = local_weight(w)
    if mesh is None:
        return qmat(x, w, impl)
    return sharded_matmul(x, w, impl)


def _share(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    a, b = split_range(y.shape[-1], mesh.mp_size, mesh.model_index)
    return y[..., a:b]


def _replicated(t, what: str) -> torch.Tensor:
    if isinstance(t, Shard):
        raise ValueError(f"{what} is replicated (lora_partition_specs)")
    return t


def _col_block(b, mesh: Mesh) -> torch.Tensor:
    """This rank's output columns of an adapter's ``b``."""
    return b.local if isinstance(b, Shard) else _share(b, mesh)


def _row_block(a, width: int, mesh: Mesh) -> torch.Tensor:
    """This rank's input rows of an adapter's ``a``: those of its share of
    the input, ``width`` columns a rank."""
    if isinstance(a, Shard):
        return a.local
    i = mesh.model_index
    return a[i * width:(i + 1) * width]


def columns(x, ws, impl: str = "auto") -> list:
    """``x`` (the whole input, on every rank) by each column-parallel
    linear of ``ws`` (q / k / v, gate / up): this rank's share of each
    output's columns. The products share one input, so its gradient is
    summed over "model" once (``copy_to``). A ``LoraWeight``'s side path
    ``(x @ a) @ b`` takes ``x @ a`` whole on every rank (``a`` is
    replicated), its gradient summed over "model" on its own, and this
    rank's columns of ``b``."""
    mesh = _mesh()
    if mesh is None or mesh.mp_size == 1:
        return [_mm(x, w, impl, mesh) for w in ws]
    xc = copy_to(x, mesh)
    out = []
    for w in ws:
        base = base_weight(w)
        y = _mm(xc, base, impl, mesh)
        if not (isinstance(base, Shard) and base.kind == "col"):
            y = _share(y, mesh)  # a replicated weight: every column
        if isinstance(w, LoraWeight):
            a = _replicated(w.a, "a column LoRA's a")
            u = copy_to(x @ a.to(x.dtype), mesh)
            y = y + u @ _col_block(w.b, mesh).to(x.dtype)
        out.append(y)
    return out


def column(x, w, impl: str = "auto"):
    """``x`` (the whole input, on every rank) by a column-parallel linear:
    this rank's share of the output columns (``columns`` of one)."""
    return columns(x, [w], impl)[0]


def row(x, w, impl: str = "auto"):
    """This rank's share of the input columns (``column``'s output) by a
    row-parallel linear: the whole output, the same on every rank. A
    ``LoraWeight``'s side path takes this rank's rows of ``a`` (split on
    its input), sums ``x @ a`` over "model" in float32, then multiplies by
    the replicated ``b``."""
    mesh = _mesh()
    if mesh is None or mesh.mp_size == 1:
        return _mm(x, w, impl, mesh)
    base = base_weight(w)
    if isinstance(base, Shard) and base.kind == "row":
        width = x.shape[-1]
        xin = x
        if not (base.start == mesh.model_index * width
                and base.stop - base.start == width
                and base.full == width * mesh.mp_size):
            # the input's shares are not the weight's chunks (a padded K):
            # the whole input, padded, then this rank's rows
            xf = gather(x, mesh, -1, consumer_replicated=False)
            xf = F.pad(xf, (0, base.full - xf.shape[-1]))
            xin = xf[..., base.start:base.stop]
        part = _mm(xin, base, impl, mesh)
        y = reduce_from(part.float(), mesh).to(part.dtype)
    else:
        # a column shard (the all-column form) multiplies the whole input
        # by its own columns; a replicated weight, the same on every rank
        split = isinstance(base, Shard)
        y = _mm(gather(x, mesh, -1, consumer_replicated=not split), base,
                impl, mesh)
        if split:
            y = gather(y, mesh, -1)
    if isinstance(w, LoraWeight):
        u = x @ _row_block(w.a, x.shape[-1], mesh).to(x.dtype)
        u = reduce_from(u.float(), mesh).to(x.dtype)
        y = y + u @ _replicated(w.b, "a row LoRA's b").to(x.dtype)
    return y


def head(x, w, impl: str = "auto"):
    """The LM head: the whole logits on every rank."""
    mesh = _mesh()
    if mesh is not None and isinstance(w, Shard):
        return gather(_mm(copy_to(x, mesh), w, impl, mesh), mesh, -1)
    return _mm(x, w, impl, mesh)


def embed(w, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of an embedding table, every column on every rank."""
    if not isinstance(w, Shard):
        return w[tokens]
    return gather(w.local[tokens], current_mesh(), dim=-1)


def local_kv_heads(kv_heads: int) -> int:
    """The kv heads a cache holds on this rank: an equal share under a
    mesh (decode_cache_specs, llama.py:200-222)."""
    mesh = _mesh()
    if mesh is None or mesh.mp_size == 1:
        return kv_heads
    if kv_heads % mesh.mp_size:
        raise ValueError(f"{kv_heads} kv heads do not split over "
                         f"{mesh.mp_size} model ranks")
    return kv_heads // mesh.mp_size


# ------------------------------------------------------------- data axis


def data_split(batch: int, mesh: Optional[Mesh] = None) -> bool:
    """Whether a batch of ``batch`` rows splits over "data" (it does where
    it divides, as the JAX specs put "data" on it)."""
    mesh = mesh or _mesh()
    return (mesh is not None and mesh.dp_size > 1
            and batch % mesh.dp_size == 0)


def data_rows(x: Optional[torch.Tensor], batch: int,
              mesh: Optional[Mesh] = None):
    """This rank's rows of ``x`` [batch, ...] (all of them where the batch
    does not divide over "data")."""
    mesh = mesh or _mesh()
    if x is None or not data_split(batch, mesh):
        return x
    a, b = split_range(batch, mesh.dp_size, mesh.data_index)
    return x[a:b]


def data_gather(y: torch.Tensor, batch: int, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Every data rank's rows of ``y`` together again (dim 0)."""
    mesh = mesh or _mesh()
    if not data_split(batch, mesh):
        return y
    return gather(y, mesh, dim=0, axis=DATA_AXIS)


def data_crop_rows(x: Optional[torch.Tensor], batch: int, crops: int = 5,
                   mesh: Optional[Mesh] = None):
    """This rank's rows of crop-major features [crops * batch, ...] (crop
    c of row b at c * batch + b, as ``ens5.five_crop`` orders them): each
    crop's block of ``data_rows``."""
    mesh = mesh or _mesh()
    if x is None or not data_split(batch, mesh):
        return x
    a, b = split_range(batch, mesh.dp_size, mesh.data_index)
    return x.reshape(crops, batch, *x.shape[1:])[:, a:b].reshape(
        -1, *x.shape[1:])


def crop_share(crops: torch.Tensor):
    """This rank's run of the crops (dim 0) split over every rank of the
    mesh, and every rank's count."""
    mesh = _mesh()
    n = crops.shape[0]
    if mesh is None:
        return crops, None
    w = mesh.world_size
    counts = [n // w + (1 if r < n % w else 0) for r in range(w)]
    a = sum(counts[: mesh.rank])
    return crops[a: a + counts[mesh.rank]], counts


def crop_gather(x: torch.Tensor, counts) -> torch.Tensor:
    """Every rank's encoded crops, in order (``crop_share``'s inverse)."""
    if counts is None:
        return x
    return gather_uneven(x, current_mesh(), counts)
