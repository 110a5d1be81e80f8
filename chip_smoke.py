"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the hand-written kernels (a3vlm_tpu_torch/csrc) with
   nvcc and prints the build time and what ptxas reported of the
   tensor-core attention kernels (registers, spills); they must not spill
   and their wgmma products must not have been serialized.
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the main path gives it; prints error and times, for
   the flash forward and its dq backward also the achieved TFLOP/s.
4. serving path: ``MetaModel`` for llama_ens5 at the full width of
   ``Ens5Config()`` (LLaMA-2-13B decoder with int4 weights, the four
   towers) on random weights from a seeded generator. Four requests (a
   448x448 image and a prompt of token ids each) go through
   ``MetaModel.generate_tokens``; every serving kernel must have launched
   there, the flash forward without its log-sum-exp. Then the prefill
   logits of the kernel path are held against the plain-PyTorch path on
   the same weights.
5. training path: the same model trained as ``main_finetune`` trains it
   with ``--quant --quant_bits 4 --lora_rank 16 --checkpointing`` (the
   int4 base frozen, rank-16 adapters, bf16 compute over float32 masters,
   AdamW with clip 8) for 4 steps on one batch of 2 images and 593 text
   ids each (sequence 2048); every training kernel must have launched
   there and the loss must fall. Then one forward and backward of the
   kernel path is held against the plain path at the same parameters.

6. latency path (run between 4 and 5, on phase 4's weights): one request
   (a 448x448 image, 45 prompt ids, 32 new tokens, greedy) through
   ``MetaModel.generate_tokens`` in each single-request mode: vanilla with
   the bf16 cache; the same with the fused write switched off (the
   attend-only decode kernel, ids equal to the fused run's); the int8 cache
   fused and two-step; prompt-lookup speculation with ``draft_k = 8`` over
   the bf16 and the int8 cache (the verify kernels); ``prefill_chunk = 512``
   (the flash kernel with fewer queries than keys); a grammar-constrained
   run, vanilla and with lookup, whose every id must be legal in its DFA
   state. Each kernel must have launched the expected number of times.
   Then one decode or verify step of the kernel path is held against the
   plain path on a copy of the same cache, and the chunked prefill's logits
   against the one-shot prefill's.

7. quantized modes (modes (i)-(n) run after phase 6 on phase 4's weights,
   mode (h) last on a model of its own): one request as in phase 6 through
   ``MetaModel.generate_tokens`` per mode: (h) ``quantize(bits=8)``, the
   int8 kernel on every decoder linear and the head; (i) ``W4A8_DECODE``,
   the W4A8 kernel on every decode step; (j) ``W8A8_PREFILL``, the W8A8
   kernel in prefill; (k) both with ``draft_k = 8``, verify rounds of 8
   rows through the W4A8 and the verify kernels; (l) ``FUSE_FFN_DOWN``, the
   GLU-fused kernel once per layer and forward; (m) the v3 int4 kernel in
   place of the v1 kernel everywhere; (n) ``quantize(tower_bits=8)`` on a
   batch of 4, the towers through ``w8a8_matmul``. Each mode's kernel must
   have launched exactly as often as its forwards say, the kernel it
   replaces not at all; then the prefill and one decode (or verify) step of
   the kernel path are held against the plain path of the same mode.

``python3 chip_smoke.py --kernels-only`` stops after phase 3.

The line before the last is the kernel table as JSON (``launches`` sums
the serving, latency, training and quantized-mode runs,
``launches_by_path`` splits them; ``bound_ms`` is the larger of the bytes
the call must move over 3.35 TB/s and its operations over 989 TFLOP/s, or
over 1979 TOP/s for the int8 tensor-core kernel; ``library_ms`` one
PyTorch library call on the same inputs, timed here and used nowhere in
the port); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from a3vlm_tpu_torch.ops import _kernels
from a3vlm_tpu_torch.ops import decode_attention as dec
from a3vlm_tpu_torch.ops.decode_attention import (
    QuantizedKV,
    decode_attention,
    decode_attention_plain,
    decode_attention_quant,
    decode_attention_quant_plain,
    decode_attention_update,
    decode_attention_update_plain,
    decode_attention_update_quant,
    decode_attention_update_quant_plain,
    dequantize_kv,
    quantize_kv_tokens,
    verify_attention,
    verify_attention_plain,
    verify_attention_quant,
    verify_attention_quant_plain,
)
from a3vlm_tpu_torch.ops.flash_attention import (
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
)
from a3vlm_tpu_torch.ops import quant_matmul as qmm
from a3vlm_tpu_torch.ops.quant_matmul import (
    int4_matmul,
    int4_matmul_2d,
    int4_matmul_2d_glu,
    int4_matmul_2d_glu_plain,
    int4_matmul_2d_plain,
    int4_matmul_2d_v3,
    int4_matmul_2d_v3_plain,
    int4_matmul_2d_w4a8,
    int4_matmul_2d_w4a8_plain,
    int4_matmul_2d_w8a8p,
    int4_matmul_2d_w8a8p_plain,
    int8_matmul_2d,
    int8_matmul_2d_plain,
    quantize_act_int8,
    requantize_w8,
    w8a8p_factors,
)
from a3vlm_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
from a3vlm_tpu_torch.quant import (
    QuantizedWeight,
    _dequantize_leaf,
    _quantize_leaf_int4,
    _quantize_leaf_int8,
)

# Kernel against plain version, both bf16 out of f32 accumulation: each side
# rounds once to bf16 (2^-8 relative each, so 2^-7 between them) and the
# f32 sums differ only in order; rtol 2^-6 leaves a factor 2 over that, and
# atol covers outputs that cancel to near zero.
RTOL = 2.0 ** -6
ATOL_FRAC = 1e-3
# Prefill logits, kernel path against plain path, relative Frobenius error:
# the paths round to bf16 at the same places and differ in summation order
# and in f32 vs bf16 softmax weights, so each of the 40 layers perturbs the
# residual stream by about one bf16 rounding (~0.4%); 5% bounds that with
# room for the random weights' spread.
LOGITS_REL_TOL = 5e-2
# Training, kernel path against plain path, one forward and backward at the
# same parameters (bf16 compute over f32 masters): the loss is a mean over
# 1184 tokens of the same logits the serving check bounds at 5e-2, and a
# mean is steadier than its terms, so 2e-2 relative; the flattened
# gradients of all trainable leaves must point the same way, cosine >= 0.99
# (bf16 rounding of p and ds in the backward kernels and of the activations
# perturbs each gradient by about 1%, which costs far less than 0.01 of
# cosine).
TRAIN_LOSS_REL_TOL = 2e-2
TRAIN_GRAD_COS_MIN = 0.99
# Latency path, one decode or verify step, kernel path against plain path
# on copies of one cache: LOGITS_REL_TOL as for the prefill. It holds for
# the int8 cache too, because both paths read the SAME int8 values and
# scales (the quantization error is common to both and cancels): the
# kernel folds the scales in at score level in f32, the plain path rounds
# the dequantized panels to bf16 (2^-9 relative per element, averaged down
# by the 128-term dot products), so a layer still differs by about one bf16
# rounding of its output, as with the bf16 cache.

# The A8 modes against the exact int4 path, one matmul, relative Frobenius
# error. The JAX package's tests hold its emulations to 1% (W4A8: the
# activations round to 8 bits per row) and 2% (W8A8 prefill: each weight
# also moves by at most smax / 31.75) at K = 2048. A row's absmax, and with
# it the rounding step, grows with K (about 0.9% at K = 5120 for Gaussian
# rows, before the bf16 rounding of both outputs), so twice those here: a
# guard against a wrong kernel, not an accuracy claim.
W4A8_REL_ENVELOPE = 0.02
W8A8P_REL_ENVELOPE = 0.04

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, dense bf16 tensor-core rate and dense int8 tensor-core rate, for
# ``bound_ms``.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1979e12

KERNELS = {
    "int4_matmul": ("a3vlm_tpu_torch/csrc/int4_matmul.cu",
                    "a3vlm_tpu/ops/quant_matmul.py:80", int4_matmul_2d),
    "flash_attention": ("a3vlm_tpu_torch/csrc/flash_attention.cu",
                        "a3vlm_tpu/ops/flash_attention.py:100",
                        flash_attention_bhsd),
    "decode_attention": ("a3vlm_tpu_torch/csrc/decode_attention.cu",
                         "a3vlm_tpu/ops/decode_attention.py:1069",
                         decode_attention_update),
    "vit_attention": ("a3vlm_tpu_torch/csrc/vit_attention.cu",
                      "a3vlm_tpu/ops/vit_attention.py:31", vit_attention),
    "flash_attention_bwd_dq": ("a3vlm_tpu_torch/csrc/flash_attention_bwd.cu",
                               "a3vlm_tpu/ops/flash_attention.py:358",
                               flash_attention_bwd_dq),
    "flash_attention_bwd_dkv": ("a3vlm_tpu_torch/csrc/flash_attention_bwd.cu",
                                "a3vlm_tpu/ops/flash_attention.py:414",
                                flash_attention_bwd_dkv),
    "decode_attention_attend": ("a3vlm_tpu_torch/csrc/decode_attention.cu",
                                "a3vlm_tpu/ops/decode_attention.py:164",
                                decode_attention),
    "decode_attention_q8": ("a3vlm_tpu_torch/csrc/decode_attention_q8.cu",
                            "a3vlm_tpu/ops/decode_attention.py:326",
                            decode_attention_quant),
    "decode_attention_q8_fused": (
        "a3vlm_tpu_torch/csrc/decode_attention_q8.cu",
        "a3vlm_tpu/ops/decode_attention.py:1331",
        decode_attention_update_quant),
    "verify_attention": ("a3vlm_tpu_torch/csrc/verify_attention.cu",
                         "a3vlm_tpu/ops/decode_attention.py:635",
                         verify_attention),
    "verify_attention_q8": ("a3vlm_tpu_torch/csrc/verify_attention.cu",
                            "a3vlm_tpu/ops/decode_attention.py:731",
                            verify_attention_quant),
    "int8_matmul": ("a3vlm_tpu_torch/csrc/int8_matmul.cu",
                    "a3vlm_tpu/ops/quant_matmul.py:993", int8_matmul_2d),
    "int4_matmul_w4a8": ("a3vlm_tpu_torch/csrc/int4_matmul_a8.cu",
                         "a3vlm_tpu/ops/quant_matmul.py:194",
                         int4_matmul_2d_w4a8),
    "int4_matmul_w8a8p": ("a3vlm_tpu_torch/csrc/int4_matmul_a8.cu",
                          "a3vlm_tpu/ops/quant_matmul.py:238",
                          int4_matmul_2d_w8a8p),
    "int4_matmul_glu": ("a3vlm_tpu_torch/csrc/int4_matmul.cu",
                        "a3vlm_tpu/ops/quant_matmul.py:105",
                        int4_matmul_2d_glu),
    "int4_matmul_v3": ("a3vlm_tpu_torch/csrc/int4_matmul.cu",
                       "a3vlm_tpu/ops/quant_matmul.py:147",
                       int4_matmul_2d_v3),
}
TENSOR_CORE_ATTENTION = ("flash_attention", "flash_attention_bwd_dq")
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel")
SERVE_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                 "vit_attention")
LATENCY_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                   "vit_attention", "decode_attention_attend",
                   "decode_attention_q8", "decode_attention_q8_fused",
                   "verify_attention", "verify_attention_q8")
TRAIN_KERNELS = ("int4_matmul", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "vit_attention")
QUANT_KERNELS = ("int8_matmul", "int4_matmul_w4a8", "int4_matmul_w8a8p",
                 "int4_matmul_glu", "int4_matmul_v3", "int4_matmul",
                 "flash_attention", "decode_attention", "verify_attention",
                 "vit_attention")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def check_build_log(library, kernels) -> list[str]:
    """What ptxas said (``-Xptxas -v``, kept beside the library) of the
    kernels whose names contain one of ``kernels``: template arguments,
    registers, spills. The tensor-core kernels must not spill, and ptxas
    must not have serialized their wgmma products (its C7513 and C7520
    notes; no other kernel issues wgmma)."""
    text = _kernels.build_log(library).read_text()
    for code in ("C7513", "C7520"):
        if code in text:
            FAILURES.append(f"build: ptxas serialized wgmma products ({code})")
    lines, name, spills = [], None, ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            hit = re.search(r"(%s)(I\w+?E)EvP" % "|".join(kernels),
                            entry.group(1))
            name = hit.group(1) + hit.group(2) if hit else None
        elif name and "spill" in line:
            spills = line.strip()
            if "0 bytes spill stores, 0 bytes spill loads" not in line:
                FAILURES.append(f"build: {name} spills: {spills}")
        elif name and "Used" in line:
            used = line.split(":", 1)[1].strip()
            lines.append(f"{name}: {used}; {spills}")
            name = None
    if not lines:
        FAILURES.append("build: no ptxas report of " + ", ".join(kernels))
    return lines


FAILURES: list[str] = []


def timed_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |kernel - plain|; a mismatch is recorded in FAILURES, and phase 3
    raises once every kernel has been checked."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        FAILURES.append(f"{name}: kernel output not finite")
    err = (got - want).abs()
    bound = RTOL * want.abs() + ATOL_FRAC * want.abs().max()
    worst = float(err.nan_to_num(float("inf")).max())
    bad = err > bound
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        FAILURES.append(
            f"{name}: {int(bad.sum())} of {bad.numel()} outside "
            f"{RTOL:.4g} * |plain| + {ATOL_FRAC:.1g} * max|plain|; max err "
            f"{worst:.4g}; first at flat index {i}: kernel "
            f"{float(got.flatten()[i]):.5g} plain {float(want.flatten()[i]):.5g}"
        )
    return worst


def randn(*shape, gen, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(results, name, case, err, ms, plain, bytes_moved, flops,
           library_ms, peak_ops: float = PEAK_FLOPS_PER_S) -> None:
    """One phase-3 row. ``bound_ms``: the larger of ``bytes_moved`` (each
    input read once, each output written once; of a cache only the rows
    this call's data makes visible) over the card's memory rate and
    ``flops`` over ``peak_ops``, the card's dense rate for the operands'
    type (bf16 unless given)."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak_ops * 1e3
    results.append({
        "name": name, "case": case, "err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": library_ms, "flops": flops,
    })


_SDPA_HAS_GQA = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")


def sdpa_operands(q, k, v):
    """k, v and keyword arguments that make
    ``F.scaled_dot_product_attention`` share kv heads over the query group:
    its own option where it has one, else expanded copies."""
    G = q.shape[1] // k.shape[1]
    if G == 1:
        return k, v, {}
    if _SDPA_HAS_GQA:
        return k, v, {"enable_gqa": True}
    return k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), {}


def sdpa_ms(q, k, v, mask=None, causal=False, reps=5) -> float:
    """The library yardstick: one ``scaled_dot_product_attention`` call over
    bhsd operands (never called by the port)."""
    k, v, kw = sdpa_operands(q, k, v)
    return timed_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, **kw), reps=reps)


def causal_pairs(Sq: int, Skv: int) -> int:
    """(query, key) pairs a right-aligned causal mask leaves visible."""
    return Sq * (Skv - Sq) + Sq * (Sq + 1) // 2


def right_aligned_mask(Sq: int, Skv: int):
    """[Sq, Skv] bool for the library call when Sq < Skv (its own causal
    flag aligns to the top left), None when Sq == Skv."""
    if Sq == Skv:
        return None
    rows = torch.arange(Sq, device="cuda")[:, None]
    cols = torch.arange(Skv, device="cuda")[None, :]
    return cols <= rows + (Skv - Sq)


def check_int4(gen, results):
    cases = []
    for M in (4, 4 * 1487):
        for K, N in ((5120, 5120), (5120, 13824), (13824, 5120),
                     (5120, 32000)):
            cases.append((M, K, N))
    for M, K, N in cases:
        w = (torch.rand(K, N, generator=gen, device="cuda") * 2 - 1)
        qw = _quantize_leaf_int4((w / K ** 0.5).to(torch.bfloat16))
        del w
        x = randn(M, K, gen=gen)
        kpad = qw.q.shape[0] * 2
        x2 = torch.nn.functional.pad(x, (0, kpad - K)).contiguous()
        got = int4_matmul(x, qw)
        want = int4_matmul(x, qw, impl="plain")
        err = compare(f"int4 M={M} K={K} N={N}", got, want)
        ms = timed_ms(lambda: int4_matmul_2d(x2, qw.q, qw.scale, qw.group),
                      reps=3)
        plain = timed_ms(
            lambda: int4_matmul_2d_plain(x2, qw.q, qw.scale, qw.group),
            reps=3)
        # no single library call takes packed int4: dequantize + matmul
        library = timed_ms(
            lambda: x @ _dequantize_leaf(qw, torch.bfloat16), reps=3)
        record(results, "int4_matmul", f"M={M} K={K}(pad {kpad}) N={N}", err,
               ms, plain, nbytes(x2, qw.q, qw.scale, got), 2 * M * kpad * N,
               library)

# Decoder linears of the 13B model: (K, N) of wq/wk/wv/wo, w1/w3, w2, head.
LINEAR_SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000))
GEMV_MS = (1, 4, 8, 32)        # decode batches and verify spans
TILED_MS = (1487, 4 * 1487)    # prefill of one request and of four


def random_weight(K, N, gen):
    w = torch.rand(K, N, generator=gen, device="cuda") * 2 - 1
    return (w / K ** 0.5).to(torch.bfloat16)


def padded(x, qw):
    kpad = qw.q.shape[0] * 2
    return F.pad(x, (0, kpad - x.shape[1])).contiguous()


def reps_for(M: int) -> int:
    return 10 if M <= 32 else 3


def check_int8(gen, results):
    """K6 at every decoder linear, K unpadded (13824 for w2)."""
    for K, N in LINEAR_SHAPES:
        qw = _quantize_leaf_int8(random_weight(K, N, gen))
        for M in GEMV_MS + TILED_MS:
            x = randn(M, K, gen=gen)
            got = int8_matmul_2d(x, qw.q, qw.scale)
            err = compare(f"int8 M={M} K={K} N={N}", got,
                          int8_matmul_2d_plain(x, qw.q, qw.scale))
            reps = reps_for(M)
            record(results, "int8_matmul", f"M={M} K={K} N={N}", err,
                   timed_ms(lambda: int8_matmul_2d(x, qw.q, qw.scale), reps),
                   timed_ms(lambda: int8_matmul_2d_plain(x, qw.q, qw.scale),
                            reps=1),
                   nbytes(x, qw.q, qw.scale, got), 2 * M * K * N,
                   timed_ms(lambda: x @ _dequantize_leaf(qw, torch.bfloat16),
                            reps))


def check_int4_variants(gen, results):
    """K1v3, K7 and K8 at the decoder linears, on one packed weight per
    shape. K7 and K8 are also held against the exact int4 math inside
    the JAX package's envelopes; K8 must equal its plain version bit for
    bit."""
    for K, N in LINEAR_SHAPES:
        qw = _quantize_leaf_int4(random_weight(K, N, gen))
        kpad = qw.q.shape[0] * 2
        wargs = (qw.q, qw.scale, qw.group)
        shape = f"K={K}(pad {kpad}) N={N}"
        for M in GEMV_MS + TILED_MS:
            x = padded(randn(M, K, gen=gen), qw)
            reps = reps_for(M)
            flops = 2 * M * kpad * N

            def dense():
                return x[:, :K] @ _dequantize_leaf(qw, torch.bfloat16)

            library = timed_ms(dense, reps)
            exact = int4_matmul_2d_plain(x, *wargs).float()

            got = int4_matmul_2d_v3(x, *wargs)
            err = compare(f"int4 v3 M={M} {shape}", got,
                          int4_matmul_2d_v3_plain(x, *wargs))
            record(results, "int4_matmul_v3", f"M={M} {shape}", err,
                   timed_ms(lambda: int4_matmul_2d_v3(x, *wargs), reps),
                   timed_ms(lambda: int4_matmul_2d_v3_plain(x, *wargs),
                            reps=1),
                   nbytes(x, qw.q, qw.scale, got), flops, library)

            if M <= 32:
                got = int4_matmul_2d_w4a8(x, *wargs)
                err = compare(f"w4a8 M={M} {shape}", got,
                              int4_matmul_2d_w4a8_plain(x, *wargs))
                rel = rel_err(got, exact)
                if not rel < W4A8_REL_ENVELOPE:
                    FAILURES.append(f"w4a8 M={M} {shape}: rel err {rel:.3e} "
                                    f"against the exact int4 product")
                record(results, "int4_matmul_w4a8",
                       f"M={M} {shape} rel_vs_exact={rel:.2e}", err,
                       timed_ms(lambda: int4_matmul_2d_w4a8(x, *wargs), reps),
                       timed_ms(lambda: int4_matmul_2d_w4a8_plain(x, *wargs),
                                reps=1),
                       nbytes(x, qw.q, qw.scale, got), flops, library,
                       peak_ops=PEAK_INT8_OPS_PER_S)
            else:
                got = int4_matmul_2d_w8a8p(x, *wargs)
                want = int4_matmul_2d_w8a8p_plain(x, *wargs)
                err = float((got.float() - want.float()).abs().max())
                if not torch.equal(got, want):
                    FAILURES.append(
                        f"w8a8p M={M} {shape}: kernel differs from its plain "
                        f"version in {int((got != want).sum())} of "
                        f"{got.numel()} elements, max {err:.4g}")
                rel = rel_err(got, exact)
                if not rel < W8A8P_REL_ENVELOPE:
                    FAILURES.append(f"w8a8p M={M} {shape}: rel err {rel:.3e} "
                                    f"against the exact int4 product")
                # library yardstick: the same math over a weight that was
                # requantized beforehand, the integer product one call
                ratio, cs = w8a8p_factors(qw.scale)
                w8 = requantize_w8(qw.q, ratio, qw.group)

                def int_mm():
                    xq, xs = quantize_act_int8(x)
                    return (torch._int_mm(xq, w8).float() * xs * cs).to(
                        torch.bfloat16)

                record(results, "int4_matmul_w8a8p",
                       f"M={M} {shape} rel_vs_exact={rel:.2e}", err,
                       timed_ms(lambda: int4_matmul_2d_w8a8p(x, *wargs), reps),
                       timed_ms(lambda: int4_matmul_2d_w8a8p_plain(x, *wargs),
                                reps=1),
                       nbytes(x, qw.q, qw.scale, got), flops,
                       timed_ms(int_mm, reps), peak_ops=PEAK_INT8_OPS_PER_S)
                del w8


def check_glu(gen, results):
    """K11 at the FFN tail's shape (w2), and at the square one."""
    for K, N in ((13824, 5120), (5120, 5120)):
        qw = _quantize_leaf_int4(random_weight(K, N, gen))
        kpad = qw.q.shape[0] * 2
        for M in GEMV_MS + TILED_MS:
            g = padded(randn(M, K, gen=gen), qw)
            u = padded(randn(M, K, gen=gen), qw)
            res = randn(M, N, gen=gen)
            args = (g, u, qw.q, qw.scale, res, qw.group)
            got = int4_matmul_2d_glu(*args)
            case = f"M={M} K={K}(pad {kpad}) N={N}"
            err = compare(f"glu {case}", got, int4_matmul_2d_glu_plain(*args))
            reps = reps_for(M)
            record(results, "int4_matmul_glu", case, err,
                   timed_ms(lambda: int4_matmul_2d_glu(*args), reps),
                   timed_ms(lambda: int4_matmul_2d_glu_plain(*args), reps=1),
                   nbytes(g, u, qw.q, qw.scale, res, got), 2 * M * kpad * N,
                   timed_ms(lambda: res + (F.silu(g[:, :K]) * u[:, :K])
                            @ _dequantize_leaf(qw, torch.bfloat16), reps))


def check_flash(gen, results):
    # the batch-4 prefill, GQA, a chunk of a chunked prefill, a short
    # right-aligned chunk, and the single-request prefill
    for B, Hq, Hkv, Sq, Skv in ((4, 40, 40, 1487, 1487),
                                (4, 40, 8, 1487, 1487),
                                (4, 40, 40, 512, 1487),
                                (1, 40, 40, 476, 1500),
                                (1, 40, 40, 1487, 1487)):
        D = 128
        q = randn(B, Hq, Sq, D, gen=gen)
        k = randn(B, Hkv, Skv, D, gen=gen)
        v = randn(B, Hkv, Skv, D, gen=gen)
        got = flash_attention_bhsd(q, k, v, causal=True)
        want = flash_attention_bhsd_plain(q, k, v, causal=True)
        err = compare(f"flash B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv}",
                      got, want)
        ms = timed_ms(lambda: flash_attention_bhsd(q, k, v, causal=True))
        plain = timed_ms(lambda: flash_attention_bhsd_plain(q, k, v, True))
        mask = right_aligned_mask(Sq, Skv)
        library = sdpa_ms(q, k, v, mask=mask, causal=mask is None)
        record(results, "flash_attention",
               f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D}", err, ms,
               plain, nbytes(q, k, v, got),
               4 * D * B * Hq * causal_pairs(Sq, Skv), library)


def sdpa_backward_ms(q, k, v, do, mask, reps=3) -> float:
    """The library yardstick of the backward kernels: the backward pass of
    one ``scaled_dot_product_attention`` call (dq, dk and dv together)."""
    with torch.inference_mode(False), torch.enable_grad():
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        do = do.clone()
        mask = None if mask is None else mask.clone()
        ke, ve, kw = sdpa_operands(q, k, v)
        out = F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask, is_causal=mask is None, **kw)
        return timed_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do, retain_graph=True), reps=reps)


def check_flash_bwd(gen, results):
    """K2 with its lse and K9a/K9b at the training shapes (B 2, S 2048),
    GQA, right-aligned, and one sample alone; both backward sides get the
    kernel's output and lse."""
    for B, Hq, Hkv, Sq, Skv in ((2, 40, 40, 2048, 2048),
                                (2, 40, 8, 2048, 2048),
                                (2, 40, 40, 512, 2048),
                                (1, 40, 40, 2048, 2048)):
        D = 128
        case = f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D}"
        q = randn(B, Hq, Sq, D, gen=gen)
        k = randn(B, Hkv, Skv, D, gen=gen)
        v = randn(B, Hkv, Skv, D, gen=gen)
        do = randn(B, Hq, Sq, D, gen=gen)
        pairs = B * Hq * causal_pairs(Sq, Skv)
        mask = right_aligned_mask(Sq, Skv)
        out, lse = flash_attention_bhsd(q, k, v, True, return_lse=True)
        _, want_lse = flash_attention_bhsd_plain(q, k, v, True,
                                                 return_lse=True)
        err = compare(f"flash lse {case}", lse, want_lse)
        ms = timed_ms(lambda: flash_attention_bhsd(q, k, v, True,
                                                   return_lse=True))
        plain = timed_ms(lambda: flash_attention_bhsd_plain(
            q, k, v, True, return_lse=True), reps=3)
        library = sdpa_ms(q, k, v, mask=mask, causal=mask is None)
        record(results, "flash_attention", f"lse {case}", err, ms, plain,
               nbytes(q, k, v, out, lse), 4 * D * pairs, library)

        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, True)
        # the library's backward forms dq, dk and dv in one call, so both
        # backward kernels are held against the same time
        library = sdpa_backward_ms(q, k, v, do, mask)
        dq = flash_attention_bwd_dq(*args)
        err = compare(f"bwd dq {case}", dq,
                      flash_attention_bwd_dq_plain(*args))
        ms = timed_ms(lambda: flash_attention_bwd_dq(*args))
        plain = timed_ms(lambda: flash_attention_bwd_dq_plain(*args), reps=3)
        record(results, "flash_attention_bwd_dq", case, err, ms, plain,
               nbytes(q, k, v, do, lse, delta, dq), 6 * D * pairs, library)

        got = flash_attention_bwd_dkv(*args)
        want = flash_attention_bwd_dkv_plain(*args)
        err = max(compare(f"bwd dk {case}", got[0], want[0]),
                  compare(f"bwd dv {case}", got[1], want[1]))
        moved = nbytes(q, k, v, do, lse, delta, *got)
        del got, want
        ms = timed_ms(lambda: flash_attention_bwd_dkv(*args))
        plain = timed_ms(lambda: flash_attention_bwd_dkv_plain(*args),
                         reps=3)
        record(results, "flash_attention_bwd_dkv", case, err, ms, plain,
               moved, 8 * D * pairs, library)


def valid_mask(valid, S, span: int = 1):
    """[B, 1, span, S] bool for the library call: window row i sees columns
    < valid[b] - span + 1 + i."""
    thr = valid.long()[:, None] - span + 1 + torch.arange(
        span, device="cuda")[None, :]
    return (torch.arange(S, device="cuda")[None, None, :]
            < thr[:, :, None])[:, None]


def check_decode(gen, results):
    B, Hkv, G, S, D = 4, 40, 1, 1544, 128
    q = randn(B, Hkv, G, D, gen=gen)
    ck = randn(B, Hkv, S, D, gen=gen)
    cv = randn(B, Hkv, S, D, gen=gen)
    nk = randn(B, Hkv, D, gen=gen)
    nv = randn(B, Hkv, D, gen=gen)
    pos = torch.tensor([1486, 1500, 1523, 1538], dtype=torch.int32,
                       device="cuda")
    valid = pos + 1
    ck1, cv1 = ck.clone(), cv.clone()
    ck2, cv2 = ck.clone(), cv.clone()
    got = decode_attention_update(q, ck1, cv1, nk, nv, pos, valid)
    want = decode_attention_update_plain(q, ck2, cv2, nk, nv, pos, valid)
    err = compare("decode", got, want)
    if not (torch.equal(ck1, ck2) and torch.equal(cv1, cv2)):
        FAILURES.append("decode: kernel caches differ from plain")
    changed = (ck1 != ck).any(-1) | (cv1 != cv).any(-1)  # [B, Hkv, S]
    expect = torch.zeros_like(changed)
    expect[torch.arange(B), :, pos.long()] = True
    if bool((changed & ~expect).any()):
        FAILURES.append("decode: kernel wrote rows other than pos")
    ms = timed_ms(lambda: decode_attention_update(q, ck1, cv1, nk, nv, pos,
                                                  valid), reps=20)
    plain = timed_ms(lambda: decode_attention_update_plain(
        q, ck2, cv2, nk, nv, pos, valid), reps=20)
    library = sdpa_ms(q, ck1, cv1, mask=valid_mask(valid, S), reps=20)
    rows = int(valid.sum())
    record(results, "decode_attention", f"B={B} Hkv={Hkv} G={G} S={S} D={D}",
           err, ms, plain,
           2 * rows * Hkv * D * 2 + nbytes(q, got) + 2 * nbytes(nk, nv),
           4 * D * Hkv * G * rows, library)


def check_latency_kernels(gen, results):
    """The decode and verify kernels of the latency path against their
    plain versions: the attend-only bf16 kernel (equal to the fused
    kernel's output bit for bit), the int8 kernels (the fused one leaving
    caches bit-identical to the plain version's) and the verify kernels at
    spans 2, 8 and 16; batch 1 and 4, GQA, a cache length that is no
    multiple of 256, ragged ``pos`` and ``valid``."""
    D = 128
    for B, Hkv, G, S in ((1, 40, 1, 1544), (4, 40, 1, 1544),
                         (4, 8, 5, 1544), (2, 40, 1, 1000)):
        Hq = Hkv * G
        case = f"B={B} Hkv={Hkv} G={G} S={S} D={D}"
        q = randn(B, 1, Hq, D, gen=gen)
        ck = randn(B, Hkv, S, D, gen=gen)
        cv = randn(B, Hkv, S, D, gen=gen)
        xk = randn(B, 1, Hkv, D, gen=gen)
        xv = randn(B, 1, Hkv, D, gen=gen)
        pos = torch.randint(S - 64, S, (B,), generator=gen,
                            device="cuda").to(torch.int32)
        pos[0] = 1499 if S > 1500 else S - 3  # the latency request's length
        valid = pos + 1
        rows = int(valid.sum())
        qb = q.transpose(1, 2)  # bhsd for the library call

        # attend-only bf16: after the fused kernel wrote the row, its output
        # must equal the fused kernel's exactly
        c1, c2 = ck.clone(), cv.clone()
        fused = decode_attention_update(
            q.reshape(B, Hkv, G, D), c1, c2, xk.reshape(B, Hkv, D),
            xv.reshape(B, Hkv, D), pos, valid)
        got = decode_attention(q, c1, c2, valid)
        if not torch.equal(got.reshape(B, Hkv, G, D), fused):
            FAILURES.append(f"attend-only decode {case}: differs from the "
                            f"fused kernel's output")
        err = compare(f"attend-only decode {case}", got,
                      decode_attention_plain(q, c1, c2, valid))
        record(results, "decode_attention_attend", case, err,
               timed_ms(lambda: decode_attention(q, c1, c2, valid), reps=20),
               timed_ms(lambda: decode_attention_plain(q, c1, c2, valid),
                        reps=20),
               2 * rows * Hkv * D * 2 + nbytes(q, got),
               4 * D * Hq * rows,
               sdpa_ms(qb, c1, c2, mask=valid_mask(valid, S), reps=20))

        # int8 cache of the same values
        kq = QuantizedKV(*quantize_kv_tokens(ck.transpose(1, 2)))
        vq = QuantizedKV(*quantize_kv_tokens(cv.transpose(1, 2)))
        kd, vd = dequantize_kv(kq), dequantize_kv(vq)
        q8_bytes = 2 * rows * Hkv * (D + 4) + nbytes(q, got)
        got = decode_attention_quant(q, kq, vq, valid)
        err = compare(f"int8 decode {case}", got,
                      decode_attention_quant_plain(q, kq, vq, valid))
        library = sdpa_ms(qb, kd, vd, mask=valid_mask(valid, S), reps=20)
        record(results, "decode_attention_q8", case, err,
               timed_ms(lambda: decode_attention_quant(q, kq, vq, valid),
                        reps=20),
               timed_ms(lambda: decode_attention_quant_plain(q, kq, vq,
                                                             valid), reps=20),
               q8_bytes, 4 * D * Hq * rows, library)

        k1, v1, k2, v2 = (QuantizedKV(c.qv.clone(), c.scale.clone())
                          for c in (kq, vq, kq, vq))
        got = decode_attention_update_quant(q, k1, v1, xk, xv, pos, valid)
        want = decode_attention_update_quant_plain(q, k2, v2, xk, xv, pos,
                                                   valid)
        err = compare(f"int8 fused decode {case}", got, want)
        same = all(torch.equal(a, b) for a, b in
                   zip((*k1, *v1), (*k2, *v2)))
        if not same:
            FAILURES.append(f"int8 fused decode {case}: caches or scales "
                            f"differ from the plain version's")
        if bool(((k1.qv != kq.qv).any(-1) | (k1.scale != kq.scale)).sum()
                > B * Hkv):
            FAILURES.append(f"int8 fused decode {case}: wrote rows other "
                            f"than pos")
        record(results, "decode_attention_q8_fused", case, err,
               timed_ms(lambda: decode_attention_update_quant(
                   q, k1, v1, xk, xv, pos, valid), reps=20),
               timed_ms(lambda: decode_attention_update_quant_plain(
                   q, k2, v2, xk, xv, pos, valid), reps=20),
               q8_bytes + nbytes(xk, xv) + 2 * B * Hkv * (D + 4),
               4 * D * Hq * rows, library)

        for span in (8, 2, 16):  # 8 first: the latency path's draft_k
            qs = randn(B, span, Hq, D, gen=gen)
            qsb = qs.transpose(1, 2)
            mask = valid_mask(valid, S, span)
            seen = int(mask.sum())  # visible (row, column) pairs per head
            vcase = f"span={span} {case}"
            got = verify_attention(qs, ck, cv, valid)
            err = compare(f"verify {vcase}", got,
                          verify_attention_plain(qs, ck, cv, valid))
            record(results, "verify_attention", vcase, err,
                   timed_ms(lambda: verify_attention(qs, ck, cv, valid),
                            reps=20),
                   timed_ms(lambda: verify_attention_plain(qs, ck, cv, valid),
                            reps=20),
                   2 * rows * Hkv * D * 2 + nbytes(qs, got),
                   4 * D * Hq * seen,
                   sdpa_ms(qsb, ck, cv, mask=mask, reps=20))
            got = verify_attention_quant(qs, kq, vq, valid)
            err = compare(f"int8 verify {vcase}", got,
                          verify_attention_quant_plain(qs, kq, vq, valid))
            record(results, "verify_attention_q8", vcase, err,
                   timed_ms(lambda: verify_attention_quant(qs, kq, vq, valid),
                            reps=20),
                   timed_ms(lambda: verify_attention_quant_plain(
                       qs, kq, vq, valid), reps=20),
                   2 * rows * Hkv * (D + 4) + nbytes(qs, got),
                   4 * D * Hq * seen,
                   sdpa_ms(qsb, kd, vd, mask=mask, reps=20))


def check_vit(gen, results):
    for H, D in ((16, 64), (16, 88), (24, 64)):
        B, S = 20, 257
        q = randn(B, S, H, D, gen=gen)
        k = randn(B, S, H, D, gen=gen)
        v = randn(B, S, H, D, gen=gen)
        got = vit_attention(q, k, v)
        want = vit_attention_plain(q, k, v)
        err = compare(f"vit H={H} D={D}", got, want)
        ms = timed_ms(lambda: vit_attention(q, k, v), reps=20)
        plain = timed_ms(lambda: vit_attention_plain(q, k, v), reps=20)
        qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))
        record(results, "vit_attention", f"B={B} S={S} H={H} D={D}", err,
               ms, plain, nbytes(q, k, v, got), 4 * B * H * S * S * D,
               sdpa_ms(qb, kb, vb, reps=20))


def reset_launches() -> None:
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    flash_attention_bhsd.lse_launches = 0


def require_counts(launches: dict, names, path: str) -> None:
    missing = [n for n in names if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def require_launched(names, path: str) -> dict:
    launches = {n: KERNELS[n][2].launches for n in names}
    require_counts(launches, names, path)
    return launches


def run_main_path(card: str):
    """Phase 4; returns the model and the serving kernels' launch counts
    from the generate run."""
    from a3vlm_tpu_torch.config import Ens5Config
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import ens5
    from a3vlm_tpu_torch.models.llama import KVCache

    t0 = time.perf_counter()
    cfg = Ens5Config()
    model = MetaModel(
        "llama_ens5", with_visual=True, max_seq_len=2048,
        dtype=torch.bfloat16, vocab_size=32000, model_cfg=cfg, seed=0,
    )
    model.quantize(bits=4)
    torch.cuda.synchronize()
    print(f"[{card}] model built (random weights, int4 decoder) in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(1)
    mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
    std = torch.tensor(ens5.CLIP_STD, device="cuda")
    pixels = torch.rand(4, 448, 448, 3, generator=gen, device="cuda")
    images = ((pixels - mean) / std).to(torch.bfloat16)
    lengths = (37, 41, 45, 52)
    prompts = [
        [1] + torch.randint(3, 32000, (n - 1,), generator=gen,
                            device="cuda").tolist()
        for n in lengths
    ]

    # warm-up request: library handles, cuDNN plans and the allocator are
    # set up here, so the stage times below are those of a served request
    model.generate_tokens(prompts, images=images, max_gen_len=2)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    outs = model.generate_tokens(prompts, images=images, max_gen_len=32,
                                 temperature=0.0)
    torch.cuda.synchronize()
    launches = require_launched(SERVE_KERNELS, "serving")
    print(f"[{card}] launches in the serving path: {launches}")
    if flash_attention_bhsd.lse_launches:
        raise AssertionError("serving launched the flash forward with lse")
    total = 32 + max(lengths)  # rows with shorter prompts run longer
    if len(outs) != 4 or any(len(o) > total - n
                             for o, n in zip(outs, lengths)):
        raise AssertionError(f"generated token lists malformed: {outs}")
    if any(not (0 <= t < 32000) for o in outs for t in o):
        raise AssertionError("generated token id out of vocabulary")
    st = model.last_stats
    print(f"[{card}] towers {st['towers_ms']:.1f} ms, prefill "
          f"{st['prefill_ms']:.1f} ms, decode {st['decode_ms']:.1f} ms over "
          f"{st['decode_steps']} steps = "
          f"{st['decode_ms'] / max(st['decode_steps'], 1):.2f} ms/token "
          f"(batch 4)")
    print(f"[{card}] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{card}] generated lengths {[len(o) for o in outs]}")

    # kernel path against plain path on the same weights
    P = 32  # prefill bucket of the shortest prompt (37 -> 32)
    tokens = torch.tensor([p[:P] for p in prompts], device="cuda")
    results = {}
    for impl in ("auto", "plain"):
        with torch.inference_mode():
            img = model.encode_images(images, impl=impl)
            cache = KVCache.create(cfg.llama, 4, P + img.shape[1],
                                   dtype=torch.bfloat16, device="cuda")
            logits, _, _ = ens5.prefill(model.params, model.cfg, cache, tokens,
                                        image_tokens=img, impl=impl)
        if not (torch.isfinite(img).all() and torch.isfinite(logits).all()):
            raise AssertionError(f"{impl} path: non-finite outputs")
        results[impl] = (img, logits)
        del cache
    (img_k, lg_k), (img_p, lg_p) = results["auto"], results["plain"]
    if img_k.shape != (4, cfg.image_words, cfg.llama.dim):
        raise AssertionError(f"image tokens shape {tuple(img_k.shape)}")
    if lg_k.shape != (4, 32000):
        raise AssertionError(f"logits shape {tuple(lg_k.shape)}")
    img_rel = float((img_k.float() - img_p.float()).norm()
                    / img_p.float().norm())
    rel = float((lg_k - lg_p).norm() / lg_p.norm())
    agree = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    print(f"[{card}] image tokens rel err kernel vs plain {img_rel:.3e}")
    print(f"[{card}] prefill logits rel err kernel vs plain {rel:.3e} "
          f"(limit {LOGITS_REL_TOL}); first-token agreement {agree}/4")
    if rel > LOGITS_REL_TOL:
        raise AssertionError(f"prefill logits rel err {rel:.3e} > "
                             f"{LOGITS_REL_TOL}")
    return model, launches


class _PieceTable:
    """A synthetic tokenizer table for ``constrained.compile_grammar``: ids
    0..2 are specials (id 2 EOS), then one piece per character the triad
    grammars use, then every two-digit string, then pieces no grammar
    accepts, up to ``n_words``."""

    def __init__(self, n_words: int):
        chars = "0123456789.,[]<>/- abcdefghijklmnopqrstuvwxyz_:"
        pieces = ["", "", ""] + list(chars)
        pieces += [f"{a}{b}" for a in "0123456789" for b in "0123456789"]
        pieces += [f"~{i}" for i in range(n_words - len(pieces))]
        self.pieces = pieces
        self.n_words = n_words
        self.eos_id = 2

    def id_to_piece(self, t: int) -> str:
        return self.pieces[t]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def first_difference(a: list, b: list):
    """Index where two id lists first differ, None when equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def clone_cache(cache):
    from a3vlm_tpu_torch.models.llama import KVCache

    def copy(c):
        if isinstance(c, QuantizedKV):
            return QuantizedKV(c.qv.clone(), c.scale.clone())
        return c.clone()

    return KVCache([copy(c) for c in cache.k], [copy(c) for c in cache.v])


def run_latency_path(card: str, model) -> dict:
    """Phase 6; returns the latency kernels' launch counts summed over the
    requests of all modes (the step checks after them are not counted)."""
    from a3vlm_tpu_torch import constrained
    from a3vlm_tpu_torch.generation import _prefill_bucket
    from a3vlm_tpu_torch.lookup_decode import _verify_step
    from a3vlm_tpu_torch.models import ens5, llama
    from a3vlm_tpu_torch.models.llama import KVCache
    from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype

    cfg, args = model.cfg, model.args
    L, W = args.n_layers, model.image_words
    gen = torch.Generator(device="cuda").manual_seed(2)
    mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
    std = torch.tensor(ens5.CLIP_STD, device="cuda")
    pixels = torch.rand(1, 448, 448, 3, generator=gen, device="cuda")
    image = ((pixels - mean) / std).to(torch.bfloat16)
    n_prompt, n_new = 45, 32
    prompt = [[1] + torch.randint(3, 32000, (n_prompt - 1,), generator=gen,
                                  device="cuda").tolist()]
    t0 = time.perf_counter()
    fsm = constrained.compile_grammar(constrained.joint_rec_grammar(),
                                      _PieceTable(32000))
    print(f"[{card}] grammar compiled over a 32000-piece table in "
          f"{time.perf_counter() - t0:.1f} s: {fsm.n_states} states")

    def run(label, expect, **kw):
        """One request; ``expect`` maps kernel name -> launches per layer
        and (decode step | verify round), checked against the run."""
        before = {n: KERNELS[n][2].launches for n in KERNELS}
        torch.cuda.reset_peak_memory_stats()
        out = model.generate_tokens(prompt, images=image, max_gen_len=n_new,
                                    temperature=0.0, **kw)[0]
        torch.cuda.synchronize()
        st = model.last_stats
        delta = {n: KERNELS[n][2].launches - before[n] for n in KERNELS}
        delta = {n: c for n, c in delta.items() if c}
        steps = st["decode_steps"]
        total = st["towers_ms"] + st["prefill_ms"] + st["decode_ms"]
        print(f"[{card}] latency {label}: towers {st['towers_ms']:.1f} ms, "
              f"prefill {st['prefill_ms']:.1f} ms, decode "
              f"{st['decode_ms']:.1f} ms over {steps} steps "
              f"({st['decode_ms'] / max(steps, 1):.2f} ms each), request "
              f"{total:.1f} ms for {len(out)} ids = {total / len(out):.2f} "
              f"ms per emitted token; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {delta}")
        if not out or any(not (0 <= t < 32000) for t in out):
            raise AssertionError(f"{label}: malformed ids {out}")
        for name, per_step in expect.items():
            if delta.get(name, 0) != per_step * L * steps:
                raise AssertionError(
                    f"{label}: {name} launched {delta.get(name, 0)} times, "
                    f"want {per_step} x {L} layers x {steps} steps")
        return out, delta

    def report_ids(label, ids, ref):
        at = first_difference(ids, ref)
        print(f"[{card}] latency {label}: ids "
              + ("equal the vanilla run's" if at is None
                 else f"first differ from the vanilla run's at index {at}"))

    # warm-up request: batch-1 library plans (as phase 4 does for batch 4)
    model.generate_tokens(prompt, images=image, max_gen_len=2)
    reset_launches()
    # (a) vanilla, bf16 cache: the reference ids
    ref, _ = run("(a) vanilla bf16", {"decode_attention": 1})
    # (b) the two-step path: write, then the attend-only kernel
    dec.FUSE_UPDATE_ATTEND = False
    try:
        two_step, _ = run("(b) bf16, write then attend",
                          {"decode_attention_attend": 1,
                           "decode_attention": 0})
        if two_step != ref:
            raise AssertionError("(b): ids differ from the fused run's")
        model.kv_cache_bits = 8
        q8_two_step, _ = run("(c2) int8 cache, write then attend",
                             {"decode_attention_q8": 1,
                              "decode_attention_q8_fused": 0})
    finally:
        dec.FUSE_UPDATE_ATTEND = True
    # (c) int8 cache, fused quantize + write + attend
    q8, _ = run("(c) int8 cache fused", {"decode_attention_q8_fused": 1,
                                         "decode_attention": 0})
    if q8 != q8_two_step:
        raise AssertionError("(c): fused and two-step int8 ids differ")
    report_ids("(c) int8 cache", q8, ref)
    # (e) lookup over the int8 cache, (d) over the bf16 cache
    spec8, _ = run("(e) draft_k=8 int8 cache", {"verify_attention_q8": 1},
                   draft_k=8)
    print(f"[{card}] latency (e) last_spec_stats {model.last_spec_stats}")
    report_ids("(e) lookup int8 vs vanilla int8", spec8, q8)
    model.kv_cache_bits = None
    spec, _ = run("(d) draft_k=8 bf16 cache", {"verify_attention": 1},
                  draft_k=8)
    print(f"[{card}] latency (d) last_spec_stats {model.last_spec_stats}")
    report_ids("(d) lookup bf16", spec, ref)
    # (f) chunked prefill: the flash kernel with fewer queries than keys
    model.prefill_chunk = 512
    chunked, delta = run("(f) prefill_chunk=512", {"decode_attention": 1})
    model.prefill_chunk = None
    pieces = -(-(_prefill_bucket(n_prompt) + W) // 512)
    if delta.get("flash_attention", 0) != L * pieces:
        raise AssertionError(
            f"(f): flash kernel launched {delta.get('flash_attention', 0)} "
            f"times, want {L} layers x {pieces} pieces")
    report_ids("(f) chunked prefill", chunked, ref)
    # (g) grammar-constrained, vanilla and with lookup
    table = fsm.next_state
    for label, kw in (("(g) grammar", {}),
                      ("(g) grammar draft_k=8", {"draft_k": 8})):
        ids, _ = run(label, {}, fsm=fsm, **kw)
        state = 0
        for i, t in enumerate(ids):
            if table[state, t] < 0:
                raise AssertionError(f"{label}: id {t} at index {i} is "
                                     f"illegal in DFA state {state}")
            state = int(table[state, t])
        print(f"[{card}] latency {label}: all {len(ids)} ids legal: "
              + "".join(_PieceTable(32000).pieces[t] for t in ids))
    launches = require_launched(LATENCY_KERNELS, "latency")

    # one step of the kernel path against the plain path on copies of one
    # cache: a decode step over the int8 cache (c), a verify step over the
    # bf16 (d) and the int8 cache (e); and (f) chunked against one-shot
    tokens = torch.tensor(prompt, device="cuda")
    S = n_prompt + W
    with torch.inference_mode():
        img = model.encode_images(image)
        lp = model.params["llama"]
        draft = torch.randint(3, 32000, (8,), generator=gen, device="cuda")
        for bits in (None, 8):
            cache = KVCache.create(args, 1, S + 16,
                                   dtype=kv_cache_dtype(bits, "cuda"),
                                   device="cuda")
            one_shot, cache, _ = llama.prefill(lp, args, cache, tokens, img)
            checks = []
            if bits == 8:
                checks.append(("(c) int8 decode step", lambda c, impl:
                               llama.decode_step(lp, args, c, draft[None, :1],
                                                 S, impl)[0]))
            checks.append((f"({'e' if bits else 'd'}) verify step, "
                           f"{'int8' if bits else 'bf16'} cache",
                           lambda c, impl: _verify_step(lp, args, c, draft, S,
                                                        impl)[0]))
            for label, step in checks:
                got = step(clone_cache(cache), "auto")
                want = step(clone_cache(cache), "plain")
                rel = rel_err(got, want)
                print(f"[{card}] latency {label}: logits rel err kernel vs "
                      f"plain {rel:.3e} (limit {LOGITS_REL_TOL})")
                if not rel <= LOGITS_REL_TOL:
                    raise AssertionError(f"{label}: logits rel err {rel}")
            if bits is None:
                cache2 = KVCache.create(args, 1, S + 16, dtype=torch.bfloat16,
                                        device="cuda")
                chunk_lg, _, _ = llama.prefill_chunked(lp, args, cache2,
                                                       tokens, img, 512)
                rel = rel_err(chunk_lg, one_shot)
                print(f"[{card}] latency (f) chunked vs one-shot prefill "
                      f"logits rel err {rel:.3e} (limit {LOGITS_REL_TOL})")
                if not rel <= LOGITS_REL_TOL:
                    raise AssertionError(f"(f): logits rel err {rel}")
                del cache2
            del cache
    return launches


class _QuantRequest:
    """The single request of phase 7 (as phase 6's) and what every mode
    shares: launch accounting per request, and the kernel-against-plain
    check of one prefill and one decode or verify step."""

    N_PROMPT, N_NEW = 45, 32

    def __init__(self, card: str, model):
        from a3vlm_tpu_torch.models import ens5

        self.card, self.model = card, model
        gen = torch.Generator(device="cuda").manual_seed(2)
        mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
        std = torch.tensor(ens5.CLIP_STD, device="cuda")
        pixels = torch.rand(1, 448, 448, 3, generator=gen, device="cuda")
        self.image = ((pixels - mean) / std).to(torch.bfloat16)
        self.prompt = [[1] + torch.randint(
            3, 32000, (self.N_PROMPT - 1,), generator=gen,
            device="cuda").tolist()]
        self.draft = torch.randint(3, 32000, (8,), generator=gen,
                                   device="cuda")
        self.totals = {n: 0 for n in KERNELS}

    def run(self, label: str, expect: dict, images=None, prompts=None, **kw):
        """One request. ``expect`` maps kernel name -> a function of
        (forwards at prefill, decode steps or verify rounds) giving the
        exact launch count wanted; kernels mapped to 0 must not launch."""
        model = self.model
        before = {n: KERNELS[n][2].launches for n in KERNELS}
        torch.cuda.reset_peak_memory_stats()
        outs = model.generate_tokens(
            prompts or self.prompt,
            images=self.image if images is None else images,
            max_gen_len=self.N_NEW, temperature=0.0, **kw)
        torch.cuda.synchronize()
        st = model.last_stats
        delta = {n: KERNELS[n][2].launches - before[n] for n in KERNELS}
        for n, c in delta.items():
            self.totals[n] += c
        delta = {n: c for n, c in delta.items() if c}
        steps = st["decode_steps"]
        print(f"[{self.card}] quant {label}: towers {st['towers_ms']:.1f} "
              f"ms, prefill {st['prefill_ms']:.1f} ms, decode "
              f"{st['decode_ms']:.1f} ms over {steps} steps "
              f"({st['decode_ms'] / max(steps, 1):.2f} ms each); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {delta}")
        for out in outs:
            if not out or any(not (0 <= t < 32000) for t in out):
                raise AssertionError(f"{label}: malformed ids {out}")
        for name, want in expect.items():
            want = want(steps) if callable(want) else want
            if delta.get(name, 0) != want:
                raise AssertionError(
                    f"{label}: {name} launched {delta.get(name, 0)} times, "
                    f"want {want} ({steps} steps)")
        return outs[0]

    def report_ids(self, label: str, ids, ref, what: str) -> None:
        agree = sum(a == b for a, b in zip(ids, ref))
        print(f"[{self.card}] quant {label}: {agree} of {len(ref)} ids "
              f"agree with {what}")

    def forwards(self, label: str, verify: bool = False):
        """Prefill and one decode step (``verify``: a verify step of 8
        rows) of the kernel path against the plain path of the mode that is
        switched on, same weights, the step on copies of one cache.
        Returns the kernel path's prefill logits."""
        from a3vlm_tpu_torch.lookup_decode import _verify_step
        from a3vlm_tpu_torch.models import llama
        from a3vlm_tpu_torch.models.llama import KVCache

        model, args = self.model, self.model.args
        lp = model.params["llama"]
        tokens = torch.tensor(self.prompt, device="cuda")
        S = self.N_PROMPT + model.image_words
        with torch.inference_mode():
            img = model.encode_images(self.image)
            got = {}
            for impl in ("auto", "plain"):
                cache = KVCache.create(args, 1, S + 16, dtype=torch.bfloat16,
                                       device="cuda")
                got[impl], cache, _ = llama.prefill(lp, args, cache, tokens,
                                                    img, impl=impl)
                if impl == "plain":
                    del cache
                else:
                    kept = cache
            self._hold(f"{label} prefill", got["auto"], got["plain"])
            if verify:
                def step(c, impl):
                    return _verify_step(lp, args, c, self.draft, S, impl)[0]
            else:
                def step(c, impl):
                    return llama.decode_step(lp, args, c, self.draft[None, :1],
                                             S, impl)[0]
            self._hold(f"{label} {'verify' if verify else 'decode'} step",
                       step(clone_cache(kept), "auto"),
                       step(clone_cache(kept), "plain"))
        return got["auto"]

    def _hold(self, label: str, got, want) -> None:
        rel = rel_err(got, want)
        print(f"[{self.card}] quant {label}: logits rel err kernel vs plain "
              f"{rel:.3e} (limit {LOGITS_REL_TOL})")
        if not (torch.isfinite(got).all() and rel <= LOGITS_REL_TOL):
            raise AssertionError(f"{label}: logits rel err {rel}")


# launches of one request: a forward runs 7 linears in each of the 40
# layers and the head; a vanilla request is 1 prefill forward and ``steps``
# decode forwards
PER_FORWARD = 40 * 7 + 1


def run_quant_modes(card: str, model) -> dict:
    """Phase 7, modes (i)-(n), on phase 4's int4 model. Returns the launch
    counts summed over the modes' requests (the checks are not counted)."""
    from a3vlm_tpu_torch.models import ens5, llama

    req = _QuantRequest(card, model)
    L = model.args.n_layers
    reset_launches()
    # the exact int4 path: the ids and prefill logits the inexact modes are
    # printed against
    ref = req.run("(ref) exact int4", {
        "int4_matmul": lambda s: PER_FORWARD * (1 + s),
        "decode_attention": lambda s: L * s})
    exact_logits = req.forwards("(ref) exact int4")

    def against_exact(label, logits, ids):
        print(f"[{card}] quant {label}: prefill logits rel err against the "
              f"exact int4 path {rel_err(logits, exact_logits):.3e}")
        req.report_ids(label, ids, ref, "the exact int4 run's")

    # (i) W4A8 decode: every M <= 32 matmul, the prefill's head (one row)
    # among them, through the W4A8 kernel; the prefill's linears stay
    qmm.W4A8_DECODE = True
    try:
        ids = req.run("(i) W4A8 decode", {
            "int4_matmul_w4a8": lambda s: 1 + PER_FORWARD * s,
            "int4_matmul": PER_FORWARD - 1, "int4_matmul_w8a8p": 0})
        against_exact("(i)", req.forwards("(i) W4A8"), ids)
        # (k) both A8 modes and lookup: the whole prompt prefilled through
        # the W8A8 kernel, rounds of 8 rows through the W4A8 kernel and K5
        qmm.W8A8_PREFILL = True
        ids = req.run("(k) W4A8 + W8A8P + draft_k=8", {
            "int4_matmul_w8a8p": PER_FORWARD - 1,
            "int4_matmul_w4a8": lambda s: 1 + PER_FORWARD * s,
            "verify_attention": lambda s: L * s,
            "int4_matmul": 0}, draft_k=8)
        print(f"[{card}] quant (k) last_spec_stats {model.last_spec_stats}")
        against_exact("(k)", req.forwards("(k) W4A8 + W8A8P", verify=True),
                      ids)
    finally:
        qmm.W4A8_DECODE = False
    # (j) W8A8 prefill alone: the prefill's 280 linears (1487 rows); its
    # head and every decode step stay on the exact GEMV
    try:
        ids = req.run("(j) W8A8 prefill", {
            "int4_matmul_w8a8p": PER_FORWARD - 1,
            "int4_matmul": lambda s: 1 + PER_FORWARD * s,
            "int4_matmul_w4a8": 0})
        against_exact("(j)", req.forwards("(j) W8A8P"), ids)
    finally:
        qmm.W8A8_PREFILL = False
    # (l) the fused FFN tail: w2 of every layer and forward, prefill too
    llama.FUSE_FFN_DOWN = True
    try:
        ids = req.run("(l) FUSE_FFN_DOWN", {
            "int4_matmul_glu": lambda s: L * (1 + s),
            "int4_matmul": lambda s: (PER_FORWARD - L) * (1 + s)})
        against_exact("(l)", req.forwards("(l) FUSE_FFN_DOWN"), ids)
    finally:
        llama.FUSE_FFN_DOWN = False
    # (m) the v3 kernel in place of v1, process-wide
    saved = qmm._AUTO_VARIANT
    qmm._AUTO_VARIANT = "v3"
    try:
        ids = req.run("(m) variant v3", {
            "int4_matmul_v3": lambda s: PER_FORWARD * (1 + s),
            "int4_matmul": 0})
        against_exact("(m)", req.forwards("(m) v3"), ids)
    finally:
        qmm._AUTO_VARIANT = saved
    # (n) int8 towers on a batch of 4 (20 crops). The towers' containers
    # are copied first: quantization replaces leaves in place, and the
    # training phase wants the dense towers back.
    gen = torch.Generator(device="cuda").manual_seed(3)
    mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
    std = torch.tensor(ens5.CLIP_STD, device="cuda")
    pixels = torch.rand(4, 448, 448, 3, generator=gen, device="cuda")
    images = ((pixels - mean) / std).to(torch.bfloat16)
    prompts = [[1] + torch.randint(3, 32000, (req.N_PROMPT - 1,),
                                   generator=gen, device="cuda").tolist()
               for _ in range(4)]
    from a3vlm_tpu_torch.quant import tree_map

    dense_towers = {k: model.params[k] for k in ens5.W8A8_TOWER_KEYS}
    with torch.inference_mode():
        dense_img = model.encode_images(images)
    dense_ids = req.run("(n0) dense towers, batch 4", {}, images=images,
                        prompts=prompts)
    try:
        for k in dense_towers:
            model.params[k] = tree_map(lambda t: t, dense_towers[k])
        model.quantize(bits=None, tower_bits=8)
        n_q = []
        tree_map(lambda t: n_q.append(isinstance(t, QuantizedWeight)),
                 {k: model.params[k] for k in dense_towers})
        if sum(n_q) < 4 * 3 + 2:
            raise AssertionError(f"(n): only {sum(n_q)} tower leaves are int8")
        ids = req.run("(n) tower_bits=8, batch 4", {
            "int4_matmul": lambda s: PER_FORWARD * (1 + s)},
            images=images, prompts=prompts)
        with torch.inference_mode():
            q_img = model.encode_images(images)
        rel = rel_err(q_img, dense_img)
        print(f"[{card}] quant (n): {sum(n_q)} tower leaves int8; image "
              f"tokens rel err against the dense towers {rel:.3e}")
        if not (torch.isfinite(q_img).all() and 0 < rel < 0.08):
            raise AssertionError(f"(n): image tokens rel err {rel}")
        req.report_ids("(n)", ids, dense_ids, "the dense-tower run's")
    finally:
        for k, v in dense_towers.items():
            model.params[k] = v
        model._generator = None
    return req.totals


def run_int8_mode(card: str) -> dict:
    """Phase 7, mode (h): a model of its own with the decoder quantized to
    int8 leaf by leaf. Returns the launch counts of its request."""
    from a3vlm_tpu_torch.config import Ens5Config
    from a3vlm_tpu_torch.meta import MetaModel

    t0 = time.perf_counter()
    model = MetaModel(
        "llama_ens5", with_visual=True, max_seq_len=2048,
        dtype=torch.bfloat16, vocab_size=32000, model_cfg=Ens5Config(),
        seed=0,
    )
    model.quantize(bits=8)
    torch.cuda.synchronize()
    print(f"[{card}] model built (random weights, int8 decoder) in "
          f"{time.perf_counter() - t0:.1f} s")
    req = _QuantRequest(card, model)
    L = model.args.n_layers
    model.generate_tokens(req.prompt, images=req.image, max_gen_len=2)
    reset_launches()
    req.run("(h) int8 decoder", {
        "int8_matmul": lambda s: PER_FORWARD * (1 + s),
        "decode_attention": lambda s: L * s, "int4_matmul": 0})
    req.forwards("(h) int8")
    return req.totals


def run_training(card: str, model) -> dict:
    """Phase 5 on phase 4's model; returns the training kernels' launch
    counts from the 4 train steps."""
    from a3vlm_tpu_torch.main_finetune import (
        make_loss_fn,
        qlora_trainable_mask,
    )
    from a3vlm_tpu_torch.models import ens5
    from a3vlm_tpu_torch.train.lora import init_lora_params
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
        partition_params,
        tree_leaves,
        value_and_grad,
    )
    from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

    gen = torch.Generator(device="cuda").manual_seed(17)
    lora = init_lora_params(gen, model.params["llama"], rank=16)
    mask = qlora_trainable_mask(model, lora, quant=True)
    model.params = mixed_precision_policy(model.params, mask, torch.bfloat16)
    params = {**model.params, "lora": lora}
    n_train = sum(t.numel() for t in
                  tree_leaves(partition_params(params, mask)[0]))
    optimizer = make_optimizer(1e-3, max_grad_norm=8.0, weight_decay=0.0)
    step = make_train_step(make_loss_fn(model, torch.bfloat16, remat=True),
                           optimizer, accum_steps=1, trainable_mask=mask)
    state = TrainState.create(params, optimizer, mask)

    mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
    std = torch.tensor(ens5.CLIP_STD, device="cuda")
    pixels = torch.rand(2, 448, 448, 3, generator=gen, device="cuda")
    text = 2048 - model.cfg.image_words  # 593 with BOS
    examples = torch.randint(3, 32000, (2, text), generator=gen,
                             device="cuda")
    examples[:, 0] = 1
    labels = examples.clone()
    labels[:, :64] = 0  # the prompt
    batch = {"examples": examples, "labels": labels,
             "image": ((pixels - mean) / std).to(torch.bfloat16)}
    tokens = examples.numel() + 2 * model.cfg.image_words
    print(f"[{card}] training: {n_train} trainable parameters (LoRA rank "
          f"16 on 7 decoder linears x 40 layers, norms, projectors, tags); "
          f"batch 2 x {text + model.cfg.image_words} tokens")

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(4):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        print(f"[{card}] train step {i}: {ms:.1f} ms, "
              f"{tokens / ms * 1e3:.1f} tokens/s, loss {loss:.6f}, "
              f"grad_norm {gnorm:.6f}")
    print(f"[{card}] train max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = require_launched(TRAIN_KERNELS, "training")
    lse = flash_attention_bhsd.lse_launches
    print(f"[{card}] launches in the 4 train steps (the forward kernels "
          f"count each block's recompute too): {launches}; flash forward "
          f"with lse {lse}")
    if lse != launches["flash_attention"]:
        raise AssertionError("a training flash forward ran without lse")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")

    # kernel path against plain path: one forward and backward, same params
    trainable, frozen = partition_params(state.params, mask)
    got = {}
    for impl in ("auto", "plain"):
        loss, grads = value_and_grad(
            make_loss_fn(model, torch.bfloat16, remat=True, impl=impl),
            trainable, frozen, batch)
        got[impl] = (float(loss), torch.cat([g.float().flatten()
                                             for g in tree_leaves(grads)]))
        del grads
    (lk, gk), (lp, gp) = got["auto"], got["plain"]
    rel = abs(lk - lp) / abs(lp)
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    print(f"[{card}] training kernel vs plain: loss {lk:.6f} vs {lp:.6f} "
          f"(rel {rel:.3e}, limit {TRAIN_LOSS_REL_TOL}); gradient cosine "
          f"{cos:.6f} (min {TRAIN_GRAD_COS_MIN}), grad norms "
          f"{float(gk.norm()):.4f} vs {float(gp.norm()):.4f}")
    if not all(math.isfinite(x) for x in (lk, lp)) or rel > TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"training loss kernel vs plain: {lk} vs {lp}")
    if not cos >= TRAIN_GRAD_COS_MIN:
        raise AssertionError(f"gradient cosine {cos} < {TRAIN_GRAD_COS_MIN}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3 (no result lines)")
    opts = parser.parse_args(argv)
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke runs on the GPU only")
    card = device_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    print(f"[{card}] kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{path.name}")
    for line in check_build_log(path, TENSOR_CORE_KERNELS):
        print(f"[{card}] ptxas {line}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    with torch.inference_mode():
        check_int4(gen, results)
        check_int8(gen, results)
        check_int4_variants(gen, results)
        check_glu(gen, results)
        check_flash(gen, results)
        check_flash_bwd(gen, results)
        check_decode(gen, results)
        check_latency_kernels(gen, results)
        check_vit(gen, results)
    for r in results:
        # the tensor-core attention kernels also get their achieved rate:
        # the row's own operation count over the kernel's time
        rate = (f" {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s"
                if r["name"] in TENSOR_CORE_ATTENTION else "")
        print(f"[{card}] {r['name']:25s} {r['case']:46s} max_abs_err "
              f"{r['err']:.3e} kernel {r['ms']:.4f} ms{rate} plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) library {r['library_ms']:.4f} ms")
    if FAILURES:
        raise AssertionError("kernel checks failed:\n" + "\n".join(FAILURES))
    if opts.kernels_only:
        return 0

    # 4. serving path, 6. latency path and 7. the quantized modes over the
    # int4 decoder (on phase 4's weights, which phase 5 recasts), 5.
    # training path, then 7. mode (h) on an int8 model of its own
    model, serve = run_main_path(card)
    latency = run_latency_path(card, model)
    quant = run_quant_modes(card, model)
    train = run_training(card, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for name, count in run_int8_mode(card).items():
        quant[name] += count
    require_counts(quant, QUANT_KERNELS, "quantized-mode")

    table = []
    for name, (source, replaces, _) in KERNELS.items():
        mine = [r for r in results if r["name"] == name]
        by_path = {"serve": serve.get(name, 0),
                   "latency": latency.get(name, 0),
                   "train": train.get(name, 0),
                   "quant": quant.get(name, 0)}
        first = mine[0]  # the row of the main path's own shape
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["err"] for r in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
