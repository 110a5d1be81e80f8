"""Falcon decoder, ``llama_type="falcon"`` (counterpart of
a3vlm_tpu/models/falcon.py): text only (no image words), the new decoder
architecture: attention and MLP in parallel over one residual, each behind
its own LayerNorm (``ln_attn``, ``ln_mlp``), grouped-query or multi-query
attention, an exact-GELU 4x MLP and **half-split** rotary (x[i] pairs with
x[i + d/2], not LLaMA's interleaved pairs). ``FalconArgs()`` is
Falcon-180B: 80 layers, hidden 14848, 232 query heads over 8 kv heads,
head dim 64.

Parameters are the JAX package's tree as tensors (``checkpoint/bridge.py``):
``word_embeddings``, ``layers`` (a per-layer list of ``attention`` wq / wk /
wv / wo, ``mlp`` dense_h_to_4h / dense_4h_to_h, ``ln_attn`` and ``ln_mlp``
with biases), ``ln_f`` and ``output``; linear weights ``[in, out]``, dense,
``QuantizedWeight`` or ``LoraWeight``. The cache is layered
[B, Hkv, S, head_dim] per layer, bf16 or int8 (``QuantizedKV``), written in
place. A decode step writes and attends in one call
(``update_and_attend_decode_cache``: the decode kernel's D 64 instance on
the card), where the JAX decode updates the cache, then attends: the same
values. ``impl`` as in ``models/llama.py``. Inside ``parallel.use_mesh``
the forward is tensor-parallel over "model" (``falcon_partition_specs``):
a rank holds its query and kv heads and its share of the MLP, and
``wo`` and ``dense_4h_to_h`` are row-parallel (falcon.py:121)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from a3vlm_tpu_torch.models._init import trunc_normal
from a3vlm_tpu_torch.models.llama import KVCache, _rope_table
from a3vlm_tpu_torch.ops.attention import attention
from a3vlm_tpu_torch.ops.decode_attention import (
    make_quantized_kv,
    update_and_attend_decode_cache,
    update_decode_cache,
)
from a3vlm_tpu_torch.ops.norms import layer_norm
from a3vlm_tpu_torch.parallel import tp
from a3vlm_tpu_torch.parallel.mesh import MODEL_AXIS, P

Params = dict


@dataclass(frozen=True)
class FalconArgs:
    """falcon.py:34-58."""

    num_layers: int = 80
    hidden_size: int = 14848
    num_attention_heads: int = 232
    num_kv_heads: Optional[int] = 8
    bias: bool = False
    multi_query: bool = False
    new_decoder_architecture: bool = True
    parallel_attn: bool = True
    layer_norm_epsilon: float = 1e-5
    vocab_size: int = -1
    rope_theta: float = 10000.0
    max_batch_size: int = 32
    max_seq_len: int = 2048
    rope_scaling: Optional[float] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        if self.multi_query:
            return 1
        return self.num_kv_heads or self.num_attention_heads


def apply_rotary_half_split(x: torch.Tensor,
                            freqs_cis: torch.Tensor) -> torch.Tensor:
    """Falcon rotary (falcon.py:61): x [B, S, H, D] by ``freqs_cis``
    [S, D/2, 2] (cos, sin), pairing x[i] with x[i + D/2], in float32, cast
    back."""
    cos = freqs_cis[..., 0][None, :, None, :]
    sin = freqs_cis[..., 1][None, :, None, :]
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def init_falcon_params(args: FalconArgs, dtype: torch.dtype,
                       device: torch.device | str,
                       generator: torch.Generator) -> Params:
    """Random weights with the JAX package's init (falcon.py:74):
    trunc-normal(0.02) embeddings, linears and head; unit LayerNorms with
    zero biases; layers as a per-layer list."""
    D, H, Hkv, hd = (args.hidden_size, args.num_attention_heads,
                     args.kv_heads, args.head_dim)

    def lin(shape):
        return {"weight": trunc_normal(shape, dtype, device, generator)}

    def ln():
        return {"weight": torch.ones(D, dtype=dtype, device=device),
                "bias": torch.zeros(D, dtype=dtype, device=device)}

    layers = [{
        "attention": {"wq": lin((D, H * hd)), "wk": lin((D, Hkv * hd)),
                      "wv": lin((D, Hkv * hd)), "wo": lin((H * hd, D))},
        "mlp": {"dense_h_to_4h": lin((D, 4 * D)),
                "dense_4h_to_h": lin((4 * D, D))},
        "ln_attn": ln(),
        "ln_mlp": ln(),
    } for _ in range(args.num_layers)]
    return {"word_embeddings": lin((args.vocab_size, D)), "layers": layers,
            "ln_f": ln(), "output": lin((D, args.vocab_size))}


def falcon_partition_specs(args: FalconArgs) -> Params:
    """Tensor-parallel specs (falcon.py:121), one per layer of the
    per-layer list: wq / wk / wv / dense_h_to_4h column-parallel, wo /
    dense_4h_to_h row-parallel, the embedding split along its dim, the head
    column-parallel, LayerNorms replicated."""
    col, row = P(None, MODEL_AXIS), P(MODEL_AXIS, None)
    ln = {"weight": P(None), "bias": P(None)}
    layer = {
        "attention": {"wq": {"weight": col}, "wk": {"weight": col},
                      "wv": {"weight": col}, "wo": {"weight": row}},
        "mlp": {"dense_h_to_4h": {"weight": col},
                "dense_4h_to_h": {"weight": row}},
        "ln_attn": ln,
        "ln_mlp": ln,
    }
    return {
        "word_embeddings": {"weight": P(None, MODEL_AXIS)},
        "layers": [layer for _ in range(args.num_layers)],
        "ln_f": {"weight": P(None), "bias": P(None)},
        "output": {"weight": P(None, MODEL_AXIS)},
    }


def falcon_cache_specs(args: FalconArgs, mesh, batch: int,
                       quant: bool = False):
    """Every layer's cache panel spec on ``mesh`` (generation.py:104):
    batch over "data", kv heads over "model", where they divide."""
    b_ax = "data" if batch % mesh.dp_size == 0 else None
    h_ax = MODEL_AXIS if args.kv_heads % mesh.mp_size == 0 else None
    return P(b_ax, h_ax, None, None)


class FalconKVCache(KVCache):
    """Layered decode cache (falcon.py:146-188, ``layered=True``): per-layer
    [batch, kv_heads, S, head_dim] tensors, S rounded up to a multiple of
    8; ``dtype=torch.int8`` makes each layer a ``QuantizedKV``."""

    @classmethod
    def create(cls, args: FalconArgs, batch_size: int,
               max_seq_len: int | None = None,
               dtype: torch.dtype = torch.bfloat16, *,
               device: torch.device | str) -> "FalconKVCache":
        S = -(-(max_seq_len or args.max_seq_len) // 8) * 8
        shape = (batch_size, tp.local_kv_heads(args.kv_heads), S,
                 args.head_dim)

        def make():
            if dtype == torch.int8:
                return [make_quantized_kv(*shape, device=device)
                        for _ in range(args.num_layers)]
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(args.num_layers)]

        return cls(make(), make())


def _block(h, lp, args: FalconArgs, freqs_cis, mask, cache_k, cache_v,
           write_pos, kv_valid_len, impl: str, attend_cache: bool = True):
    """One layer (falcon.py:191-227): attention and MLP over the same
    residual, each from its own LayerNorm."""
    B, S, _ = h.shape
    hd = args.head_dim
    eps = args.layer_norm_epsilon
    attn_in = layer_norm(h, lp["ln_attn"]["weight"], lp["ln_attn"]["bias"],
                         eps)
    mlp_in = layer_norm(h, lp["ln_mlp"]["weight"], lp["ln_mlp"]["bias"], eps)

    att = lp["attention"]
    # this rank's heads under a mesh, every head otherwise
    xq, xk, xv = (y.reshape(B, S, -1, hd) for y in tp.columns(
        attn_in, [att[n]["weight"] for n in ("wq", "wk", "wv")], impl))
    xq = apply_rotary_half_split(xq, freqs_cis)
    xk = apply_rotary_half_split(xk, freqs_cis)
    if cache_k is None:
        out = attention(xq, xk, xv, mask=mask, impl=impl)
    elif attend_cache:
        out = update_and_attend_decode_cache(
            xq, cache_k, cache_v, xk, xv, write_pos, kv_valid_len,
            mask=mask, impl=impl)
    else:
        # prefill: this call's k/v are the whole visible history
        update_decode_cache(cache_k, cache_v, xk, xv, write_pos)
        out = attention(xq, xk, xv, mask=mask, impl=impl)
    attn_out = tp.row(out.reshape(B, S, -1), att["wo"]["weight"], impl)

    mlp = lp["mlp"]
    up = F.gelu(tp.column(mlp_in, mlp["dense_h_to_4h"]["weight"], impl))
    mlp_out = tp.row(up, mlp["dense_4h_to_h"]["weight"], impl)
    return h + attn_out + mlp_out


def _freqs(args: FalconArgs, positions: torch.Tensor) -> torch.Tensor:
    """Rotary rows of ``positions`` from a ``max_seq_len * 2`` table
    (falcon.py:230)."""
    return _rope_table(args.head_dim, args.max_seq_len * 2, args.rope_theta,
                       args.rope_scaling, str(positions.device))[positions]


def _final(params: Params, args: FalconArgs, h: torch.Tensor, impl: str):
    h = layer_norm(h, params["ln_f"]["weight"], params["ln_f"]["bias"],
                   args.layer_norm_epsilon)
    return tp.head(h, params["output"]["weight"], impl)


def forward_train(params: Params, args: FalconArgs, examples: torch.Tensor,
                  remat: bool = False, impl: str = "auto") -> torch.Tensor:
    """Training forward (falcon.py:238): causal blocks without a cache,
    logits [B, S, V]. ``remat`` recomputes each block in the backward
    pass."""
    h = tp.embed(params["word_embeddings"]["weight"], examples)
    freqs_cis = _freqs(args, torch.arange(h.shape[1], device=h.device))

    def block(hc, lp):
        return _block(hc, lp, args, freqs_cis, "causal", None, None, 0, None,
                      impl)

    for lp in params["layers"]:
        h = (checkpoint(block, h, lp, use_reentrant=False) if remat
             else block(h, lp))
    return _final(params, args, h, impl)


def _run_layers_cached(params, args, h, freqs_cis, mask, cache, write_pos,
                       kv_valid_len, impl, attend_cache):
    for i, lp in enumerate(params["layers"]):
        h = _block(h, lp, args, freqs_cis, mask, cache.k[i], cache.v[i],
                   write_pos, kv_valid_len, impl, attend_cache)
    return h


def prefill(params: Params, args: FalconArgs, cache: FalconKVCache,
            tokens: torch.Tensor, impl: str = "auto"):
    """The prompt through the decoder, cache rows [0, S) written
    (falcon.py:289). Returns (last-position logits [B, V] float32, cache,
    S)."""
    h = tp.embed(params["word_embeddings"]["weight"], tokens)
    S = h.shape[1]
    freqs_cis = _freqs(args, torch.arange(S, device=h.device))
    h = _run_layers_cached(params, args, h, freqs_cis, "causal", cache, 0,
                           None, impl, attend_cache=False)
    return _final(params, args, h[:, -1, :], impl).float(), cache, S


def decode_step(params: Params, args: FalconArgs, cache: FalconKVCache,
                token: torch.Tensor, seq_pos: int, impl: str = "auto"):
    """One-token decode (falcon.py:304): ``token`` [B, 1] at position
    ``seq_pos``, its row written there and every row attending [0,
    seq_pos]. Returns ([B, V] float32 logits, cache)."""
    B = token.shape[0]
    h = tp.embed(params["word_embeddings"]["weight"], token)
    kv_valid = torch.full((B,), seq_pos + 1, dtype=torch.int32,
                          device=h.device)
    freqs_cis = _freqs(args, torch.tensor([seq_pos], device=h.device))
    h = _run_layers_cached(params, args, h, freqs_cis, None, cache,
                           kv_valid - 1, kv_valid, impl, attend_cache=True)
    return _final(params, args, h[:, -1, :], impl).float(), cache
