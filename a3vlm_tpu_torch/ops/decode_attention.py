"""Decode-cache writes and attention over the cache (counterpart of
a3vlm_tpu/ops/decode_attention.py; kernels in csrc/decode_attention.cu,
csrc/decode_attention_q8.cu and csrc/verify_attention.cu).

Caches are per-layer [B, Hkv, S, D] tensors ("bhsd", the layered decode
layout), bf16 or float32, or ``QuantizedKV`` pairs of int8 values and
per-row float32 scales. They are updated IN PLACE: that replaces the JAX
package's donated buffers and the kernels' ``input_output_aliases``.

Each kernel has a wrapper and a plain PyTorch version beside it
(``*_plain``). A wrapper launches its kernel on CUDA tensors and takes the
plain version on CPU tensors; it never falls back from a kernel that fails
to build or launch. The wrappers:

- ``decode_attention_update``: write row pos[b], attend one token (bf16);
- ``decode_attention``: the same attention without the write;
- ``decode_attention_quant`` / ``decode_attention_update_quant``: both over
  an int8 cache, the fused form quantizing the new token in the kernel;
- ``verify_attention`` / ``verify_attention_quant``: a window of 2..16 query
  tokens, causal within the window (speculative verify).

``update_decode_cache``, ``attend_decode_cache`` and
``update_and_attend_decode_cache`` are what the models call; they choose
between those wrappers, the flash kernel (chunked prefill) and the plain
path."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from a3vlm_tpu_torch.ops import _kernels
from a3vlm_tpu_torch.ops.attention import attention

_LOG2E = 1.4426950408889634


class QuantizedKV(NamedTuple):
    """int8 KV-cache buffer of one layer (decode_attention.py:59): ``qv``
    int8 [B, Hkv, S, D]; ``scale`` float32 [B, Hkv, S], symmetric per
    (batch, head, row). The dequantization folds into the attention at
    score level (s *= kscale per column; p *= vscale before the pv sum), so
    the kernels never form dequantized panels."""

    qv: torch.Tensor
    scale: torch.Tensor


def quantize_kv_tokens(x: torch.Tensor):
    """[B, S, Hkv, D] new k or v -> (int8 [B, Hkv, S, D], float32
    [B, Hkv, S]) with symmetric per-(batch, head, token) scales
    (decode_attention.py:74): float32 math, a true division, round half to
    even."""
    xt = x.transpose(1, 2).float()
    amax = torch.clamp_min(xt.abs().amax(dim=-1), 1e-8)
    # a tensor divisor: dividing a CUDA tensor by a Python number multiplies
    # by its rounded reciprocal, which is not the true quotient
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xt / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(kv: QuantizedKV, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [B, Hkv, S, D] panels (the plain path)."""
    return (kv.qv.float() * kv.scale[..., None]).to(dtype)


def kv_cache_dtype(kv_bits, device: torch.device | str = "cuda"):
    """The one place the kv_cache_bits -> cache dtype policy lives
    (decode_attention.py:88): int8 for 8 bits, else bf16 on a CUDA device
    and float32 on the CPU."""
    if kv_bits == 8:
        return torch.int8
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def make_quantized_kv(batch, kv_heads, seq_len, head_dim,
                      device: torch.device | str) -> QuantizedKV:
    """Zeroed int8 panel and float32 scale plane of one layer."""
    return QuantizedKV(
        torch.zeros((batch, kv_heads, seq_len, head_dim), dtype=torch.int8,
                    device=device),
        torch.zeros((batch, kv_heads, seq_len), dtype=torch.float32,
                    device=device),
    )


def _cache_shape(cache) -> torch.Size:
    return cache.qv.shape if isinstance(cache, QuantizedKV) else cache.shape


def _write_rows(panel, rows, write_pos) -> None:
    """panel [B, Hkv, S, ...] <- rows [B, Hkv, S_new, ...] at
    [write_pos, write_pos + S_new) of dim 2; ``write_pos`` an int or a
    per-row [B] tensor."""
    s_new, S = rows.shape[2], panel.shape[2]
    if isinstance(write_pos, torch.Tensor):
        cols = write_pos.long()[:, None] + torch.arange(
            s_new, device=panel.device)[None, :]           # [B, S_new]
        b = torch.arange(panel.shape[0], device=panel.device)[:, None]
        panel[b, :, cols] = rows.transpose(1, 2).to(panel.dtype)
        return
    if not 0 <= write_pos <= S - s_new:
        raise ValueError(f"cache write at {write_pos}+{s_new} outside "
                         f"{S} rows")
    panel[:, :, write_pos:write_pos + s_new] = rows.to(panel.dtype)


def update_decode_cache(cache_k, cache_v, xk, xv, write_pos):
    """Write this call's k/v [B, S_new, Hkv, D] into the bhsd caches at rows
    [write_pos, write_pos + S_new), in place (decode_attention.py:
    1668-1753). ``write_pos`` is an int, or a per-row [B] tensor (each row
    of the batch writes at its own position; the caller keeps every write
    inside the cache). ``QuantizedKV`` caches quantize the tokens on write.
    Returns the caches."""
    if isinstance(write_pos, torch.Tensor) and write_pos.dim() == 0:
        write_pos = int(write_pos)
    if isinstance(cache_k, QuantizedKV):
        for cache, x in ((cache_k, xk), (cache_v, xv)):
            q, scale = quantize_kv_tokens(x)
            _write_rows(cache.qv, q, write_pos)
            _write_rows(cache.scale, scale, write_pos)
        return cache_k, cache_v
    _write_rows(cache_k, xk.transpose(1, 2), write_pos)
    _write_rows(cache_v, xv.transpose(1, 2), write_pos)
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# plain versions. q rows are [B, Hkv, R, D] with a per-row column threshold.
# ---------------------------------------------------------------------------


def _attend_rows_plain(q, k, v, thr, kscale=None, vscale=None):
    """q [B, Hkv, R, D]; k, v [B, Hkv, S, D] (int8 with ``kscale``/``vscale``
    [B, Hkv, S], else dense); thr [B, R]: row r sees columns < thr[b, r].
    Float32 softmax attention; the scales fold in at score level. A row
    with no visible column gives zeros."""
    D, S = q.shape[-1], k.shape[2]
    s = torch.einsum("bhrd,bhsd->bhrs", q.float(), k.float()) * D ** -0.5
    if kscale is not None:
        s = s * kscale[:, :, None, :]
    cols = torch.arange(S, device=q.device)
    visible = cols[None, None, :] < thr.long()[:, :, None]      # [B, R, S]
    s = s.masked_fill(~visible[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    if vscale is not None:
        p = p * vscale[:, :, None, :]
    return torch.einsum("bhrs,bhsd->bhrd", p, v.float()).to(q.dtype)


def _group_rows(q, Hkv):
    """[B, Sq, Hq, D] -> [B, Hkv, G * Sq, D], row r = g * Sq + i
    (decode_attention.py:937)."""
    B, Sq, Hq, D = q.shape
    return q.transpose(1, 2).reshape(B, Hkv, (Hq // Hkv) * Sq, D)


def _ungroup_rows(out, Sq):
    """The inverse of ``_group_rows`` (decode_attention.py:943-945)."""
    B, Hkv, R, D = out.shape
    G = R // Sq
    return (out.reshape(B, Hkv, G, Sq, D).permute(0, 3, 1, 2, 4)
            .reshape(B, Sq, Hkv * G, D))


def _window_thresholds(valid, Sq, G):
    """[B, G * Sq] column thresholds of a right-aligned causal window: row
    g * Sq + i sees columns < valid[b] - Sq + 1 + i."""
    i = torch.arange(Sq, device=valid.device).repeat(G)
    return valid.long()[:, None] - Sq + 1 + i[None, :]


def decode_attention_update_plain(q, cache_k, cache_v, nk, nv, pos, valid):
    """q [B, Hkv, G, D]; caches [B, Hkv, S, D]; nk/nv [B, Hkv, D];
    pos/valid [B] int. Writes row pos[b] of both caches in place, then
    attends each query over rows [0, valid[b]) in float32. A query with no
    visible row gives zeros. Returns [B, Hkv, G, D] in q's dtype."""
    B = q.shape[0]
    idx = torch.arange(B, device=q.device)
    pos = pos.long()
    cache_k[idx, :, pos] = nk.to(cache_k.dtype)
    cache_v[idx, :, pos] = nv.to(cache_v.dtype)
    thr = valid.long()[:, None].expand(B, q.shape[2])
    return _attend_rows_plain(q, cache_k, cache_v, thr)


def decode_attention_plain(q, k, v, valid):
    """q [B, 1, Hq, D]; k, v [B, Hkv, S, D]; valid [B]: each query attends
    over rows [0, valid[b]). Returns [B, 1, Hq, D]."""
    return verify_attention_plain(q, k, v, valid)


def decode_attention_quant_plain(q, kq: QuantizedKV, vq: QuantizedKV, valid):
    """``decode_attention_plain`` over an int8 cache."""
    return verify_attention_quant_plain(q, kq, vq, valid)


def decode_attention_update_quant_plain(q, kq: QuantizedKV, vq: QuantizedKV,
                                        xk, xv, pos, valid):
    """q [B, 1, Hq, D]; xk/xv [B, 1, Hkv, D] this step's k/v; pos/valid [B].
    Quantizes the new token (``quantize_kv_tokens``), writes its int8 row
    and scale at pos[b] of both caches in place, then attends as
    ``decode_attention_quant_plain``. Returns [B, 1, Hq, D]."""
    update_decode_cache(kq, vq, xk, xv, pos)
    return decode_attention_quant_plain(q, kq, vq, valid)


def verify_attention_plain(q, k, v, valid):
    """q [B, Sq, Hq, D] a window of query tokens; k, v [B, Hkv, S, D];
    valid [B] counts the populated prefix, window included: query i attends
    columns <= valid - Sq + i. Returns [B, Sq, Hq, D]."""
    Sq, Hkv = q.shape[1], k.shape[1]
    thr = _window_thresholds(valid, Sq, q.shape[2] // Hkv)
    return _ungroup_rows(_attend_rows_plain(_group_rows(q, Hkv), k, v, thr),
                         Sq)


def verify_attention_quant_plain(q, kq: QuantizedKV, vq: QuantizedKV, valid):
    """``verify_attention_plain`` over an int8 cache."""
    Sq, Hkv = q.shape[1], kq.qv.shape[1]
    thr = _window_thresholds(valid, Sq, q.shape[2] // Hkv)
    out = _attend_rows_plain(_group_rows(q, Hkv), kq.qv, vq.qv, thr,
                             kq.scale, vq.scale)
    return _ungroup_rows(out, Sq)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cache(name, q_rows, cache_k, cache_v, valid):
    """Shapes and types the kernels share; q_rows [B, Hkv, R, D]. Returns
    (B, Hkv, R, S)."""
    B, Hkv, R, D = q_rows.shape
    quant = isinstance(cache_k, QuantizedKV)
    _kernels.require(isinstance(cache_v, QuantizedKV) == quant,
                     f"{name}: k and v caches of different kinds")
    shape = _cache_shape(cache_k)
    S = shape[2]
    _kernels.require(D == 128, f"{name}: D must be 128")
    _kernels.require(tuple(shape) == (B, Hkv, S, D)
                     and _cache_shape(cache_v) == shape,
                     f"{name}: cache shape")
    _kernels.require(valid.shape == (B,), f"{name}: valid shape")
    _kernels.require_cuda(name, q_rows, dtype=torch.bfloat16)
    _kernels.require_cuda(name, valid, dtype=torch.int32)
    if quant:
        _kernels.require(cache_k.scale.shape == (B, Hkv, S)
                         and cache_v.scale.shape == (B, Hkv, S),
                         f"{name}: scale shape")
        _kernels.require_cuda(name, cache_k.qv, cache_v.qv, dtype=torch.int8)
        _kernels.require_cuda(name, cache_k.scale, cache_v.scale,
                              dtype=torch.float32)
    else:
        _kernels.require_cuda(name, cache_k, cache_v, dtype=torch.bfloat16)
    return B, Hkv, R, S


def _scratch(q_rows, P):
    """Per-row partial (max, sum, acc) buffers and the output."""
    B, Hkv, R, D = q_rows.shape
    part_m = torch.empty((B, Hkv, R, P), dtype=torch.float32,
                         device=q_rows.device)
    part_acc = torch.empty((B, Hkv, R, P, D), dtype=torch.float32,
                           device=q_rows.device)
    return part_m, torch.empty_like(part_m), part_acc, torch.empty_like(q_rows)


def decode_attention_update(q, cache_k, cache_v, nk, nv, pos, valid):
    """Wrapper of the fused write+attend kernel (decode_attention.py:1612;
    the TPU kernels at :981 and :1069). Shapes as the plain version; on
    CUDA all bf16 and contiguous, D == 128, pos/valid int32. A pos outside
    [0, S) writes nothing."""
    if q.device.type == "cpu":
        return decode_attention_update_plain(q, cache_k, cache_v, nk, nv,
                                             pos, valid)
    name = "decode_attention_update"
    B, Hkv, G, S = _check_cache(name, q, cache_k, cache_v, valid)
    D = q.shape[-1]
    _kernels.require(nk.shape == (B, Hkv, D) and nv.shape == nk.shape,
                     f"{name}: new k/v shape")
    _kernels.require(pos.shape == (B,), f"{name}: pos shape")
    _kernels.require_cuda(name, nk, nv, dtype=torch.bfloat16)
    _kernels.require_cuda(name, pos, dtype=torch.int32)
    lib = _kernels.lib()
    part_m, part_l, part_acc, out = _scratch(q, lib.a3_decode_partials(S))
    err = lib.a3_decode_update_attend(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), nk.data_ptr(),
        nv.data_ptr(), pos.data_ptr(), valid.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, Hkv, G, S,
        _LOG2E / math.sqrt(D), _kernels.stream(),
    )
    decode_attention_update.launches += 1
    _kernels.check(err, "a3_decode_update_attend")
    return out


decode_attention_update.launches = 0


def decode_attention(q, k, v, valid):
    """Wrapper of the attend-only decode kernel (decode_attention.py:526;
    the TPU kernels at :111 and :164): the fused kernel with its write
    switched off. q [B, 1, Hq, D]; k, v [B, Hkv, S, D]; valid [B] int32;
    on CUDA bf16 and D == 128. Returns [B, 1, Hq, D]."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid)
    name = "decode_attention"
    _kernels.require(q.shape[1] == 1, f"{name}: one query token")
    qg = _group_rows(q, k.shape[1]).contiguous()
    B, Hkv, G, S = _check_cache(name, qg, k, v, valid)
    lib = _kernels.lib()
    part_m, part_l, part_acc, out = _scratch(qg, lib.a3_decode_partials(S))
    err = lib.a3_decode_update_attend(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
        valid.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, Hkv, G, S,
        _LOG2E / math.sqrt(q.shape[-1]), _kernels.stream(),
    )
    decode_attention.launches += 1
    _kernels.check(err, "a3_decode_update_attend")
    return _ungroup_rows(out, 1)


decode_attention.launches = 0


def decode_attention_quant(q, kq: QuantizedKV, vq: QuantizedKV, valid):
    """Wrapper of the int8 attend-only decode kernel
    (decode_attention.py:600; the TPU kernels at :266 and :326). q
    [B, 1, Hq, D] bf16; int8 panels with float32 scales; valid [B] int32.
    Returns [B, 1, Hq, D]."""
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, kq, vq, valid)
    name = "decode_attention_quant"
    _kernels.require(q.shape[1] == 1, f"{name}: one query token")
    qg = _group_rows(q, kq.qv.shape[1]).contiguous()
    B, Hkv, G, S = _check_cache(name, qg, kq, vq, valid)
    lib = _kernels.lib()
    part_m, part_l, part_acc, out = _scratch(qg, lib.a3_decode_partials(S))
    err = lib.a3_decode_attend_q8(
        qg.data_ptr(), kq.qv.data_ptr(), vq.qv.data_ptr(),
        kq.scale.data_ptr(), vq.scale.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, Hkv, G, S, _LOG2E / math.sqrt(q.shape[-1]),
        _kernels.stream(),
    )
    decode_attention_quant.launches += 1
    _kernels.check(err, "a3_decode_attend_q8")
    return _ungroup_rows(out, 1)


decode_attention_quant.launches = 0


def decode_attention_update_quant(q, kq: QuantizedKV, vq: QuantizedKV, xk,
                                  xv, pos, valid):
    """Wrapper of the fused int8 write+attend kernel
    (decode_attention.py:1637; the TPU kernels at :1216 and :1331 with
    ``_quantize_new_kv`` :1204): the new token is quantized in the kernel
    with ``quantize_kv_tokens``'s math and its int8 row and two scales are
    written at pos[b], in place. q [B, 1, Hq, D], xk/xv [B, 1, Hkv, D]
    bf16; pos/valid [B] int32. A pos outside [0, S) writes nothing.
    Returns [B, 1, Hq, D]."""
    if q.device.type == "cpu":
        return decode_attention_update_quant_plain(q, kq, vq, xk, xv, pos,
                                                   valid)
    name = "decode_attention_update_quant"
    _kernels.require(q.shape[1] == 1 and xk.shape[1] == 1,
                     f"{name}: one query token")
    qg = _group_rows(q, kq.qv.shape[1]).contiguous()
    B, Hkv, G, S = _check_cache(name, qg, kq, vq, valid)
    D = q.shape[-1]
    _kernels.require(xk.shape == (B, 1, Hkv, D) and xv.shape == xk.shape,
                     f"{name}: new k/v shape")
    _kernels.require(pos.shape == (B,), f"{name}: pos shape")
    nk, nv = xk.reshape(B, Hkv, D), xv.reshape(B, Hkv, D)
    _kernels.require_cuda(name, nk, nv, dtype=torch.bfloat16)
    _kernels.require_cuda(name, pos, dtype=torch.int32)
    lib = _kernels.lib()
    part_m, part_l, part_acc, out = _scratch(qg, lib.a3_decode_partials(S))
    err = lib.a3_decode_update_attend_q8(
        qg.data_ptr(), kq.qv.data_ptr(), vq.qv.data_ptr(),
        kq.scale.data_ptr(), vq.scale.data_ptr(), nk.data_ptr(),
        nv.data_ptr(), pos.data_ptr(), valid.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B, Hkv, G, S,
        _LOG2E / math.sqrt(D), _kernels.stream(),
    )
    decode_attention_update_quant.launches += 1
    _kernels.check(err, "a3_decode_update_attend_q8")
    return _ungroup_rows(out, 1)


decode_attention_update_quant.launches = 0

VERIFY_KERNEL_MAX_SPAN = 16


def _verify_launch(name, q, cache_k, cache_v, valid):
    """Shared body of the two verify wrappers: fold the window into the row
    axis, launch, unfold."""
    Sq = q.shape[1]
    _kernels.require(1 < Sq <= VERIFY_KERNEL_MAX_SPAN,
                     f"{name}: window of {Sq} tokens, want 2..16")
    qg = _group_rows(q, _cache_shape(cache_k)[1]).contiguous()
    B, Hkv, R, S = _check_cache(name, qg, cache_k, cache_v, valid)
    lib = _kernels.lib()
    part_m, part_l, part_acc, out = _scratch(qg, lib.a3_verify_partials(S))
    tail = (valid.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), B, Hkv, R, Sq, S,
            _LOG2E / math.sqrt(q.shape[-1]), _kernels.stream())
    if isinstance(cache_k, QuantizedKV):
        err = lib.a3_verify_attend_q8(
            qg.data_ptr(), cache_k.qv.data_ptr(), cache_v.qv.data_ptr(),
            cache_k.scale.data_ptr(), cache_v.scale.data_ptr(), *tail)
    else:
        err = lib.a3_verify_attend(qg.data_ptr(), cache_k.data_ptr(),
                                   cache_v.data_ptr(), *tail)
    return err, _ungroup_rows(out, Sq)


def verify_attention(q, k, v, valid):
    """Wrapper of the verify kernel (decode_attention.py:929; the TPU
    kernel at :635). q [B, Sq, Hq, D] bf16 with 2 <= Sq <= 16; k, v
    [B, Hkv, S, D] bf16; valid [B] int32 counts the populated prefix,
    window included. Returns [B, Sq, Hq, D]."""
    if q.device.type == "cpu":
        return verify_attention_plain(q, k, v, valid)
    err, out = _verify_launch("verify_attention", q, k, v, valid)
    verify_attention.launches += 1
    _kernels.check(err, "a3_verify_attend")
    return out


verify_attention.launches = 0


def verify_attention_quant(q, kq: QuantizedKV, vq: QuantizedKV, valid):
    """Wrapper of the int8 verify kernel (decode_attention.py:948; the TPU
    kernel at :731). As ``verify_attention`` over int8 panels with float32
    scales."""
    if q.device.type == "cpu":
        return verify_attention_quant_plain(q, kq, vq, valid)
    err, out = _verify_launch("verify_attention_quant", q, kq, vq, valid)
    verify_attention_quant.launches += 1
    _kernels.check(err, "a3_verify_attend_q8")
    return out


verify_attention_quant.launches = 0


# ---------------------------------------------------------------------------
# gates and the dispatchers the models call
# ---------------------------------------------------------------------------


def _kernel_operands(xq) -> bool:
    """What every kernel of this module takes: CUDA, bf16 activations,
    D == 128. (The JAX gates' TPU-only, S % 8 and D % 128 conditions.)"""
    return (xq.device.type == "cuda" and xq.dtype == torch.bfloat16
            and xq.shape[-1] == 128)


def decode_attention_eligible(xq) -> bool:
    """xq [B, 1, Hq, 128] bf16 on CUDA (decode_attention.py:510)."""
    return xq.shape[1] == 1 and _kernel_operands(xq)


def verify_attention_eligible(xq) -> bool:
    """xq [B, Sq, Hq, 128] bf16 on CUDA with 1 < Sq <= 16
    (decode_attention.py:916)."""
    return 1 < xq.shape[1] <= VERIFY_KERNEL_MAX_SPAN and _kernel_operands(xq)


def fused_eligible(xq, cache_k, mask, kv_valid_len) -> bool:
    """Single-token bf16 decode over a bhsd cache (bf16 or int8) with
    D == 128. The JAX gate's TPU-only and S % 8 conditions do not apply
    here; CPU tensors pass too and take the wrappers' plain versions."""
    return (
        mask is None
        and kv_valid_len is not None
        and xq.shape[1] == 1
        and xq.shape[-1] == 128
        and xq.dtype == torch.bfloat16
        and (isinstance(cache_k, QuantizedKV)
             or cache_k.dtype == torch.bfloat16)
    )


# False forces the two-step path: write, then attend (the attend-only
# kernels). Read at call time.
FUSE_UPDATE_ATTEND = True


def update_and_attend_decode_cache(xq, cache_k, cache_v, xk, xv, write_pos,
                                   kv_valid_len, *, mask, impl="auto",
                                   valid_static=None):
    """Write this step's k/v into the caches (in place) and attend over
    them (decode_attention.py:1761). xq [B, Sq, Hq, D]; xk/xv
    [B, Sq, Hkv, D]; ``write_pos`` an int or [B]; ``kv_valid_len`` [B].
    Eligible single-token steps run a fused kernel under ``impl="auto"``
    (the int8 one over a ``QuantizedKV`` cache); the rest write, then
    attend through ``attend_decode_cache``. Returns out [B, Sq, Hq, D];
    the caches are updated in place."""
    B = xq.shape[0]
    if (FUSE_UPDATE_ATTEND and impl in ("auto", "flash")
            and valid_static is None and xk.shape[1] == 1
            and fused_eligible(xq, cache_k, mask, kv_valid_len)):
        if isinstance(write_pos, torch.Tensor):
            pos = write_pos.to(torch.int32).expand(B).contiguous()
        else:
            pos = torch.full((B,), write_pos, dtype=torch.int32,
                             device=xq.device)
        valid = kv_valid_len.to(torch.int32).contiguous()
        if isinstance(cache_k, QuantizedKV):
            return decode_attention_update_quant(
                xq, cache_k, cache_v, xk.contiguous(), xv.contiguous(), pos,
                valid)
        Hkv, D = cache_k.shape[1], xq.shape[-1]
        out = decode_attention_update(
            _group_rows(xq, Hkv).contiguous(), cache_k, cache_v,
            xk.reshape(B, Hkv, D).to(cache_k.dtype).contiguous(),
            xv.reshape(B, Hkv, D).to(cache_v.dtype).contiguous(), pos, valid,
        )
        return _ungroup_rows(out, 1)
    update_decode_cache(cache_k, cache_v, xk, xv, write_pos)
    return attend_decode_cache(xq, cache_k, cache_v, mask=mask,
                               kv_valid_len=kv_valid_len, impl=impl,
                               valid_static=valid_static)


def attend_decode_cache(xq, cache_k, cache_v, *, mask, kv_valid_len,
                        impl="auto", valid_static=None):
    """Attention of xq [B, Sq, Hq, D] over the whole (padded) bhsd cache
    (decode_attention.py:1817). Routes, in order, under ``impl`` "auto" or
    "flash":

    1. chunked prefill (``valid_static`` an int, causal, Sq > 1): the flash
       kernel with the first ``valid_static`` rows as keys and the chunk's
       queries right-aligned to them. The flash route masks keys uniformly
       at ``valid_static``: callers pass kv_valid_len == valid_static for
       every row of the batch. An int8 cache is dequantized to panels of
       the activation type first;
    2. a causal window of 2..16 tokens with ``kv_valid_len``: the verify
       kernel (int8 or bf16);
    3. one token, no mask, over an int8 cache: the int8 decode kernel;
    4. one token, no mask, over a bf16 cache: the decode kernel;

    else the plain path over the (dequantized) cache."""
    kernels = impl in ("auto", "flash")
    quant = isinstance(cache_k, QuantizedKV)
    causal = isinstance(mask, str) and mask == "causal"
    if (valid_static is not None and causal and xq.shape[1] > 1 and kernels
            and (impl == "flash" or xq.dtype == torch.bfloat16)):
        from a3vlm_tpu_torch.ops.flash_attention import flash_attention_bhsd

        if quant:
            keys = dequantize_kv(cache_k, xq.dtype)
            values = dequantize_kv(cache_v, xq.dtype)
        else:
            keys, values = cache_k.to(xq.dtype), cache_v.to(xq.dtype)
        out = flash_attention_bhsd(
            xq.transpose(1, 2).contiguous(), keys, values, causal=True,
            skv_actual=valid_static)
        return out.transpose(1, 2)
    if (causal and valid_static is None and kv_valid_len is not None
            and kernels and verify_attention_eligible(xq)):
        valid = kv_valid_len.to(torch.int32).contiguous()
        if quant:
            return verify_attention_quant(xq, cache_k, cache_v, valid)
        return verify_attention(xq, cache_k.to(xq.dtype),
                                cache_v.to(xq.dtype), valid)
    if (kernels and mask is None and kv_valid_len is not None
            and decode_attention_eligible(xq)):
        valid = kv_valid_len.to(torch.int32).contiguous()
        if quant:
            return decode_attention_quant(xq, cache_k, cache_v, valid)
        return decode_attention(xq, cache_k.to(xq.dtype),
                                cache_v.to(xq.dtype), valid)
    if quant:
        keys = dequantize_kv(cache_k, xq.dtype)
        values = dequantize_kv(cache_v, xq.dtype)
    else:
        keys, values = cache_k.to(xq.dtype), cache_v.to(xq.dtype)
    return attention(xq, keys.transpose(1, 2), values.transpose(1, 2),
                     mask=mask, kv_valid_len=kv_valid_len, impl="plain")
