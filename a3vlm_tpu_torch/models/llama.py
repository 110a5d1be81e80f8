"""LLaMA-2 decoder (counterpart of a3vlm_tpu/models/llama.py): inference
over a KV cache, and the cache-free training forward.

Parameters are the JAX package's tree as tensors (``checkpoint/bridge.py``):
linear weights ``[in, out]``, int4 or int8 ``QuantizedWeight`` or
``LoraWeight``, and ``"layers"`` a list of per-layer dicts (the decode layout). The KV cache
is layered, one [B, Hkv, S, D] tensor (or int8 ``QuantizedKV``) per layer
for k and for v, written IN PLACE where the JAX package donates its
buffers. ``impl="plain"`` runs
every op through its plain PyTorch version; ``"auto"`` sends
kernel-eligible ops to the kernels; ``"flash"`` also sends every causal
attention to the flash op, whatever its dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.ops.attention import attention
from a3vlm_tpu_torch.ops.decode_attention import (
    make_quantized_kv,
    update_and_attend_decode_cache,
    update_decode_cache,
)
from a3vlm_tpu_torch.ops.norms import rms_norm
from a3vlm_tpu_torch.ops.quant_matmul import int4_ffn_down, qmat
from a3vlm_tpu_torch.ops.rope import apply_rotary_emb, precompute_freqs_cis
from a3vlm_tpu_torch.quant import QuantizedWeight

Params = dict

# Send the FFN tail of int4 layers that run over a cache (prefill and
# decode) through the GLU-fused kernel: silu(gate) * up and the residual
# add folded into the w2 product (``int4_ffn_down``; llama.py:53). Off by
# default, as in the JAX package; read at every call.
FUSE_FFN_DOWN = False


class KVCache:
    """Layered decode cache (llama.py:56-107): lists ``k`` and ``v`` of
    per-layer [batch, n_kv_heads, S, head_dim] tensors, S rounded up to a
    multiple of 8 as in the JAX package. ``dtype=torch.int8`` makes each
    layer a ``QuantizedKV`` (int8 values, float32 per-row scales)."""

    def __init__(self, k: list, v: list):
        self.k = k
        self.v = v

    @classmethod
    def create(cls, args: ModelArgs, batch_size: int,
               max_seq_len: int | None = None,
               dtype: torch.dtype = torch.bfloat16, *,
               device: torch.device | str) -> "KVCache":
        S = max_seq_len or args.max_seq_len
        S = -(-S // 8) * 8
        shape = (batch_size, args.kv_heads, S, args.head_dim)

        def make():
            if dtype == torch.int8:
                return [make_quantized_kv(*shape, device=device)
                        for _ in range(args.n_layers)]
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(args.n_layers)]

        return cls(make(), make())


def init_llama_params(args: ModelArgs, dtype: torch.dtype,
                      device: torch.device | str,
                      generator: torch.Generator) -> Params:
    """Random decoder weights with the JAX package's init
    (llama.py:126): U(-1/sqrt(fan_in), 1/sqrt(fan_in)) linears, unit
    norms; layers as a per-layer list."""
    D, V = args.dim, args.vocab_size
    H, Hkv, hd, Fd = args.n_heads, args.kv_heads, args.head_dim, args.ffn_hidden_dim

    def uniform(shape, fan_in):
        t = torch.rand(shape, generator=generator, device=device)
        return ((t * 2 - 1) * fan_in ** -0.5).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    layers = []
    for _ in range(args.n_layers):
        layers.append({
            "attention": {
                "wq": {"weight": uniform((D, H * hd), D)},
                "wk": {"weight": uniform((D, Hkv * hd), D)},
                "wv": {"weight": uniform((D, Hkv * hd), D)},
                "wo": {"weight": uniform((H * hd, D), H * hd)},
            },
            "feed_forward": {
                "w1": {"weight": uniform((D, Fd), D)},
                "w2": {"weight": uniform((Fd, D), Fd)},
                "w3": {"weight": uniform((D, Fd), D)},
            },
            "attention_norm": {"weight": ones(D)},
            "ffn_norm": {"weight": ones(D)},
        })
    return {
        "tok_embeddings": {"weight": uniform((V, D), D)},
        "layers": layers,
        "norm": {"weight": ones(D)},
        "output": {"weight": uniform((D, V), D)},
    }


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok_embeddings"]["weight"][tokens]


def _attention_sublayer(x, lp, args: ModelArgs, freqs_cis, mask, cache_k,
                        cache_v, write_pos, kv_valid_len, impl: str,
                        attend_cache: bool = True, attend_valid_static=None):
    B, S, _ = x.shape
    H, Hkv, hd = args.n_heads, args.kv_heads, args.head_dim
    xq = qmat(x, lp["wq"]["weight"], impl).reshape(B, S, H, hd)
    xk = qmat(x, lp["wk"]["weight"], impl).reshape(B, S, Hkv, hd)
    xv = qmat(x, lp["wv"]["weight"], impl).reshape(B, S, Hkv, hd)
    xq, xk = apply_rotary_emb(xq, xk, freqs_cis)

    if cache_k is None:
        # training: no cache, attention over this call's own k/v
        out = attention(xq, xk, xv, mask=mask, impl=impl)
    elif attend_cache:
        out = update_and_attend_decode_cache(
            xq, cache_k, cache_v, xk, xv, write_pos, kv_valid_len,
            mask=mask, impl=impl, valid_static=attend_valid_static,
        )
    else:
        # prefill: this call's k/v are the whole visible history
        update_decode_cache(cache_k, cache_v, xk, xv, write_pos)
        out = attention(xq, xk, xv, mask=mask, impl=impl)
    return qmat(out.reshape(B, S, H * hd), lp["wo"]["weight"], impl)


def _ffn_sublayer(x, lp, impl: str):
    gate = qmat(x, lp["w1"]["weight"], impl)
    up = qmat(x, lp["w3"]["weight"], impl)
    return qmat(F.silu(gate) * up, lp["w2"]["weight"], impl)


def _block(h, lp, args: ModelArgs, freqs_cis, mask, cache_k, cache_v,
           write_pos, kv_valid_len, impl: str, attend_cache: bool = True,
           attend_valid_static=None):
    h = h + _attention_sublayer(
        rms_norm(h, lp["attention_norm"]["weight"], args.norm_eps),
        lp["attention"], args, freqs_cis, mask, cache_k, cache_v, write_pos,
        kv_valid_len, impl, attend_cache=attend_cache,
        attend_valid_static=attend_valid_static,
    )
    ffn_in = rms_norm(h, lp["ffn_norm"]["weight"], args.norm_eps)
    fw = lp["feed_forward"]
    w2 = fw["w2"]["weight"]
    if (FUSE_FFN_DOWN and cache_k is not None
            and type(w2) is QuantizedWeight and w2.bits == 4):
        # training (no cache) and LoraWeight keep the unfused ops
        gate = qmat(ffn_in, fw["w1"]["weight"], impl)
        up = qmat(ffn_in, fw["w3"]["weight"], impl)
        return int4_ffn_down(gate, up, w2, h, impl)
    return h + _ffn_sublayer(ffn_in, fw, impl)


@functools.lru_cache(maxsize=8)
def _rope_table(head_dim: int, end: int, theta: float,
                scaling: Optional[float], device: str) -> torch.Tensor:
    return precompute_freqs_cis(head_dim, end, theta=theta, scaling=scaling,
                                device=device)


def freqs_for_positions(args: ModelArgs, positions: torch.Tensor):
    """RoPE rows for absolute positions [S] -> [S, hd//2, 2], or per-row
    positions [B, S] -> [B, S, hd//2, 2]; the table has ``max_seq_len * 2``
    rows (llama.py:371)."""
    table = _rope_table(args.head_dim, args.max_seq_len * 2, args.rope_theta,
                        args.rope_scaling, str(positions.device))
    return table[positions]


def forward_hidden(params: Params, args: ModelArgs, h: torch.Tensor,
                   positions: torch.Tensor, mask, cache: KVCache,
                   write_pos=0, kv_valid_len=None,
                   impl: str = "auto", attend_cache: bool = True,
                   attend_valid_static=None):
    """All decoder blocks over a layered cache (llama.py:385-439).
    ``positions`` [S], or [B, S] for per-row positions; k/v of this call are
    written at ``write_pos`` (an int, or [B] for per-row writes); attention
    runs over the cache prefix ``kv_valid_len`` when ``attend_cache``, else
    over this call's own k/v (prefill). ``attend_valid_static`` is the
    chunked-prefill extent (``attend_decode_cache``). Returns (h, cache)."""
    freqs_cis = freqs_for_positions(args, positions)
    for i, lp in enumerate(params["layers"]):
        h = _block(h, lp, args, freqs_cis, mask, cache.k[i], cache.v[i],
                   write_pos, kv_valid_len, impl, attend_cache=attend_cache,
                   attend_valid_static=attend_valid_static)
    return h, cache


def forward_train(params: Params, args: ModelArgs, examples: torch.Tensor,
                  image_tokens: Optional[torch.Tensor] = None,
                  remat: bool = False, impl: str = "auto") -> torch.Tensor:
    """Training forward (llama.py:455): embed ``examples`` [B, S_text],
    splice ``image_tokens`` after BOS, run the causal blocks without a
    cache, and return logits for the text positions only, [B, S_text, V].
    ``remat`` recomputes each block's activations in the backward pass
    (``jax.checkpoint`` per block at llama.py:417-418)."""
    h = embed_tokens(params, examples)
    image_words = 0
    if image_tokens is not None:
        image_words = image_tokens.shape[1]
        h = torch.cat([h[:, :1], image_tokens.to(h.dtype), h[:, 1:]], dim=1)
    freqs_cis = freqs_for_positions(args, torch.arange(h.shape[1],
                                                       device=h.device))

    def block(hc, lp):
        return _block(hc, lp, args, freqs_cis, "causal", None, None, 0, None,
                      impl)

    for lp in params["layers"]:
        if remat:
            h = checkpoint(block, h, lp, use_reentrant=False)
        else:
            h = block(h, lp)
    h = rms_norm(h, params["norm"]["weight"], args.norm_eps)
    return qmat(h[:, image_words:, :], params["output"]["weight"], impl)


def prefill(params: Params, args: ModelArgs, cache: KVCache,
            tokens: torch.Tensor, image_tokens: Optional[torch.Tensor] = None,
            impl: str = "auto"):
    """[BOS | image tokens | text] through the decoder, cache rows [0, S)
    written (llama.py:483). Returns (last-position logits [B, V] float32,
    cache, S)."""
    h = embed_tokens(params, tokens)
    if image_tokens is not None:
        h = torch.cat([h[:, :1], image_tokens.to(h.dtype), h[:, 1:]], dim=1)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    h, cache = forward_hidden(params, args, h, positions, "causal",
                              cache=cache, write_pos=0, attend_cache=False,
                              impl=impl)
    h = rms_norm(h, params["norm"]["weight"], args.norm_eps)
    logits = qmat(h[:, -1, :], params["output"]["weight"], impl)
    return logits.float(), cache, S


def prefill_chunked(params: Params, args: ModelArgs, cache: KVCache,
                    tokens: torch.Tensor,
                    image_tokens: Optional[torch.Tensor] = None,
                    chunk: int = 512, impl: str = "auto"):
    """Memory-bounded prefill (llama.py:521): the spliced sequence goes
    through the decoder in ``chunk``-token pieces, each writing its cache
    rows and attending over the populated prefix, right-aligned causal, so
    activation temporaries are O(chunk) instead of O(sequence). On bf16
    CUDA tensors the cache attention of each piece is the flash kernel with
    Sq < Skv. Same return contract as ``prefill``."""
    h = embed_tokens(params, tokens)
    if image_tokens is not None:
        h = torch.cat([h[:, :1], image_tokens.to(h.dtype), h[:, 1:]], dim=1)
    B, S, _ = h.shape
    for start in range(0, S, chunk):
        end = min(start + chunk, S)
        out, cache = forward_hidden(
            params, args, h[:, start:end],
            torch.arange(start, end, device=h.device), "causal", cache=cache,
            write_pos=start,
            kv_valid_len=torch.full((B,), end, dtype=torch.int32,
                                    device=h.device),
            attend_cache=True, impl=impl, attend_valid_static=end,
        )
    h_last = rms_norm(out[:, -1, :], params["norm"]["weight"], args.norm_eps)
    logits = qmat(h_last, params["output"]["weight"], impl)
    return logits.float(), cache, S


def decode_step(params: Params, args: ModelArgs, cache: KVCache,
                token: torch.Tensor, seq_pos: int, impl: str = "auto"):
    """One-token decode (llama.py:568). ``token`` [B, 1]; ``seq_pos`` the
    absolute position in the spliced sequence. Returns ([B, V] float32
    logits, cache)."""
    B = token.shape[0]
    h = embed_tokens(params, token)
    kv_valid = torch.full((B,), seq_pos + 1, dtype=torch.int32,
                          device=h.device)
    positions = torch.tensor([seq_pos], device=h.device)
    h, cache = forward_hidden(params, args, h, positions, None, cache=cache,
                              write_pos=seq_pos, kv_valid_len=kv_valid,
                              impl=impl)
    h = rms_norm(h, params["norm"]["weight"], args.norm_eps)
    logits = qmat(h[:, -1, :], params["output"]["weight"], impl)
    return logits.float(), cache
