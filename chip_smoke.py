"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the hand-written kernels (a3vlm_tpu_torch/csrc) with
   nvcc and prints the build time and what ptxas reported of the
   tensor-core kernels (K2, K9a, K9b, K10, the tiled quantized matmuls of
   K1, K1v3, K11 and K6, K11's pre-pass, and the verify kernel of K5 and
   K5q, and K8's W8A8 tile: registers, spills), of the cluster kernels
   (the decode kernel of K3, K3u, K4 and K4 fused, and the GEMV of K1,
   K1v3, K11, K7 and K6) and of the row quantizer; they must not spill and
   the wgmma products must not have been serialized.
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the main path gives it (K2 also at phase 9's
   prefix extensions, 16-128 queries over 1472-1584 keys at batch 1 and
   4 and 512 over 1968 at batch 4, and K1 at the slot pool's M 36, 512
   and 2048);
   prints error and times, for
   the tensor-core kernels (the attention kernels, and the quantized
   matmuls at M > 32) also the achieved rate (TFLOP/s, or GB/s where bytes
   bound it) and its share of the bound; for the decode and verify kernels
   (K3, K3u, K4, K4 fused, K5, K5q), the GEMV rows (K1 at M 1, 4, 9 and
   32, K1v3, K11, K7 and K6 at M 1, 4, 8 and 32) and K8 the device time of
   a call and the kernels it launches (``torch.profiler``; for K8 also the
   kernel's own, apart from the wrapper's quantizer), the wrapper's host
   time per call, the device time's share of the bound and its ratio to
   the library call, all timed over a rotation of operand copies that
   exceeds the L2 (``cold_copies``), as a decode step finds each layer's
   cache and weights; the row quantizer's rows (K7's and K8's shapes) must
   equal its plain version bit for bit, inputs from a generator of their
   own.
4. serving path: ``MetaModel`` for llama_ens5 at the full width of
   ``Ens5Config()`` (LLaMA-2-13B decoder with int4 weights, the four
   towers) on random weights from a seeded generator. Four requests (a
   448x448 image and a prompt of token ids each) go through
   ``MetaModel.generate_tokens``; every serving kernel must have launched
   there, the flash forward without its log-sum-exp; one decode step's
   device time by kernel name (``torch.profiler``, ``decode_profile``).
   No call may take a dispatcher's fallback route (phases 4-7: every
   full-width shape lies in the kernels' domain). Then the prefill logits
   of the kernel path are held against the
   plain-PyTorch path on the same weights.
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
   state. Each kernel must have launched the expected number of times;
   after (a), one batch-1 decode step's device time by kernel name.
   Then one decode or verify step of the kernel path is held against the
   plain path on a copy of the same cache, and the chunked prefill's logits
   against the one-shot prefill's.

7. quantized modes (modes (i)-(o) run after phase 6 on phase 4's weights,
   mode (h) last on a model of its own): one request as in phase 6 through
   ``MetaModel.generate_tokens`` per mode: (h) ``quantize(bits=8)``, the
   int8 kernel on every decoder linear and the head; (i) ``W4A8_DECODE``,
   the W4A8 kernel on every decode step; (j) ``W8A8_PREFILL``, the W8A8
   kernel in prefill; (k) both with ``draft_k = 8``, verify rounds of 8
   rows through the W4A8 and the verify kernels; (l) ``FUSE_FFN_DOWN``, the
   GLU-fused kernel once per layer and forward; (m) the v3 int4 kernel in
   place of the v1 kernel everywhere; (o) ``PREFILL_DENSE_MIN_M = 256``,
   the prefill's linears through dequantize + two dense products, whose
   prefill time is printed beside the kernel route's; (n)
   ``quantize(tower_bits=8)`` on a batch of 4, the towers through
   ``w8a8_matmul``. Each mode's kernel must
   have launched exactly as often as its forwards say, the kernel it
   replaces not at all (and the row quantizer once per W4A8 and W8A8
   prefill call); then the prefill and one decode (or verify) step of the
   kernel path are held against the plain path of the same mode. One
   prefill's device time by kernel name in (ref) and in (j), one decode
   step's in (h) and (i).

8. eval path (run right after phase 4, on its weights; the model carries a
   synthetic 32000-piece tokenizer, ``_PieceTable``): probes whether
   Pillow, transformers, tokenizers and sentencepiece import; writes a task
   file of 2 images x 4 questions (PNG at 640x480 where Pillow imports,
   else point clouds) and sends it through ``VQADataset`` + ``run_eval``
   (batch 4, greedy) twice: 32 new ids unconstrained, whose ids must equal
   ``MetaModel.generate_tokens`` on the same prompts and images, and 64
   under the joint grammar (``fsm_for_task``), whose every answer must
   parse as a joint triad. Prints wall ms, towers, prefill and decode ms
   and tokens per batch, with the launch counts (K1, K2, K3 and K10 must
   have launched, no fallback route taken); writes the results file, reads
   it back against the record schema and scores it
   (``tools.score_results``), the scores equal to those of the same
   records with ``format_answer`` taken out. Then a full-width decoder cut
   to 2 layers is written as a consolidated checkpoint with its
   ``meta.json`` and ``config.json`` and loaded by
   ``MetaModel.from_pretrained(..., device="cuda")``
   (``load_consolidated_dir`` -> ``import_llama_consolidated`` ->
   ``params_from_numpy``), every decoder leaf on the card equal to what
   was written; and the CLI, ``eval_affordance.main`` with ``--device cuda
   --quant --score``, runs the task file on that checkpoint (K1, K2, K3
   and K10 launched, no fallback, the records in order and in the
   schema).

9. continuous batching (right after phase 8, on phase 4's model): phase
   8's task file through ``eval_affordance.run_eval_continuous`` with 4
   slots (one [BOS | image words] prefix a render, its questions, 278-281
   ids each from the synthetic tokenizer, admitted as one text-only
   extension at bucket 512: the flash kernel with 512 queries over 1968
   keys, K1 at M 2048): (a) greedy, 32 new ids; (b) the joint grammar, 64;
   (c) ``draft_k = 8``; (d) the int8 cache, vanilla and with
   ``draft_k = 8``; (e) ``steps_per_dispatch = 8``; then (f) an
   ``OnlineSession`` of one render's four requests, two submitted three
   rounds late, against
   ``generate`` on the same pool. K1, K2 and K10 launch in every run; K3
   in the bf16 vanilla runs, K5 in (c), K4 fused and K5q in (d); no
   fallback route. (e)'s ids equal (a)'s, (f)'s equal ``generate``'s, and
   a full-width ``decode_step_ragged`` with every row at one position
   equals ``decode_step`` bit for bit. (c) is held against (a) and (d)'s
   speculative run against its vanilla one: where ids differ, the kernel
   path's top-2 logit gap at the first differing id must not exceed its
   kernel-vs-plain logit error there. Every grammar answer parses as a
   joint triad, the records follow phase 8's schema in order. Prints per
   render the towers, prefix prefill and admission ms, the decode steps and
   ms a step, TTFT and TPOT p50 and p90, and each run's wall time beside
   phase 8's ``run_eval`` on the same items.

10. the fine-tuning loop (right after phase 5, on its model and trained
   state): (a) ``CheckpointManager.save`` of the trainables and both
   moments with ``wait=False``, two train steps while the files are
   written, ``wait_until_finished`` (``_DONE``, ``find_latest_checkpoint``
   names it); a restore into a fresh ``TrainState`` (``restore_params``
   over the live base, ``restore_train_state``) equal to what was saved
   leaf for leaf, step 4; the same two steps from there must equal the
   uninterrupted ones within the kernels' spread, measured by running them
   twice from one state. Prints the checkpoint's size, the save's blocking
   ms (the host copy), the write's seconds, the restore's seconds and peak
   memory. (b) the final state saved and served on the int4 model:
   ``load_adapter_checkpoint`` + ``generate_tokens`` on phase 4's requests
   gives the ids of ``load_lora`` of the state in memory; K1, K2, K3 and
   K10 launch, no fallback. (c) ``main_finetune.main`` at full width on a
   2-layer consolidated checkpoint as phase 8 writes it (8 dialog items
   over the task file's 2 images, batch 2, ``--quant --lora_rank 16
   --only_save_trainable --checkpointing --epochs 2
   --save_iteration_interval 2 --cache_tower_features``, a constant
   learning rate) writes ``epoch_0-iter_2``, ``epoch_0``,
   ``epoch_1-iter_2`` and ``epoch_1``; without the epoch-1 directories,
   ``--resume auto`` goes on from ``epoch_0`` and gives epoch 1's log and
   checkpoint as before, the towers replayed from the disk cache (no K10
   launch); one epoch uncached gives epoch 0's log, K10 as often; then
   ``eval_affordance.main --quant --adapter_path .../epoch_1`` over the
   task file (records in order and in the schema). (d) the dense 2-layer
   model with the adapters merged (``load_adapter_checkpoint(...,
   merge=True)``) against the same model with them unmerged: prefill
   logits within ``MERGE_REL_TOL``.

``python3 chip_smoke.py --kernels-only`` stops after phase 3.
``--ids-out PATH`` writes every run's generated ids; ``--ids-ref PATH``
holds this run's ids against another run's (a parent commit's, say, with
this script run over its package) label by label, and where they differ
prints the first differing index with this run's top-2 logit gap there
and the kernel-vs-plain logit error of that step.

The line before the last is the kernel table as JSON (``launches`` sums
the serving, continuous-batching, latency, training, quantized-mode and
fine-tuning-loop runs, ``launches_by_path`` splits them as ``serve``,
``cb``, ``latency``, ``train``, ``quant`` and ``ckpt``; ``bound_ms`` is the larger of the bytes
the call must move over 3.35 TB/s and its operations over 989 TFLOP/s, or
over 1979 TOP/s for the int8 tensor-core kernel; ``library_ms`` one
PyTorch library call on the same inputs, timed here and used nowhere in
the port); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from a3vlm_tpu_torch import serving_batch
from a3vlm_tpu_torch.generation import synchronize
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
# The card's L2 (50 MB): the decode step reads 40 layers' caches, so each
# call finds its layer's cache evicted; phase 3 times the decode and verify
# kernels over enough copies of their operands to evict them too.
L2_BYTES = 50 * 2 ** 20

# The row quantizer's plain version; a parent tree without the kernel has
# only the tensor-op version, under the wrapper's name (so this script can
# time a parent's package in the same call).
quantize_act_int8_plain = getattr(qmm, "quantize_act_int8_plain",
                                  quantize_act_int8)
QUANTIZER_KERNEL = hasattr(qmm, "quantize_act_int8_plain")

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
    # the XLA ops of quantize_act_int8 that K7's and K8's wrappers run
    # first
    "quantize_act_int8": ("a3vlm_tpu_torch/csrc/int4_matmul_a8.cu",
                          "a3vlm_tpu/ops/quant_matmul.py:399",
                          quantize_act_int8),
}
TENSOR_CORE_ATTENTION = ("flash_attention", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv", "vit_attention")
# the wrappers whose rows at M > GEMV_MAX_M run the tiled wgmma route
TILED_MATMULS = ("int4_matmul", "int4_matmul_v3", "int4_matmul_glu",
                 "int8_matmul")
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel", "vit_attn_kernel",
                       "int4_mma_kernel", "int8_mma_kernel",
                       "glu_prepass_kernel", "verify_mma_kernel",
                       "w8a8p_mma_kernel")
# the kernels without wgmma, which must not spill either: the cluster
# kernels (the decode attention of K3, K3u, K4 and K4 fused, and the GEMV
# of K1, K1v3, K11, K7 and K6) and the row quantizer
CLUSTER_PTXAS_KERNELS = ("decode_cluster_kernel", "gemv_cluster_kernel",
                         "quantize_act_kernel")
# device kernel names (substrings) for the profiles: the K8 kernel, the
# GEMVs (with the second pass an earlier design launched after them) and
# the row quantizer
W8A8P_KERNEL = "w8a8p"
GEMV_KERNELS = ("gemv", "splitk_reduce")
QUANTIZER_KERNELS = ("quantize_act",)
# the verify and decode rows also get their device time (every kernel of
# the call), kernel launches per call, the wrapper's host time per call,
# the share of the bound and the ratio to the library call; they are timed
# on a cold L2 (``cold_copies``)
VERIFY_KERNELS = ("verify_attention", "verify_attention_q8")
DECODE_KERNELS = ("decode_attention", "decode_attention_attend",
                  "decode_attention_q8", "decode_attention_q8_fused")
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
                 "vit_attention") + (
                     ("quantize_act_int8",) if QUANTIZER_KERNEL else ())


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
            # a template's arguments (I...E) follow its name, then the E
            # that closes the namespace
            hit = re.search(r"(%s)(I\w+?E)?E" % "|".join(kernels),
                            entry.group(1))
            name = hit.group(1) + (hit.group(2) or "") if hit else None
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


def device_stats(fn, kernel: str = "", reps: int = 20):
    """Mean device time per call of the kernels whose name holds
    ``kernel`` (all the call launches, by default), and how many such
    kernels a call launches, from a ``torch.profiler`` trace of ``reps``
    calls; (None, 0) when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        # device events only (a CPU event may carry its kernels' time)
        if kernel in e.key and str(e.device_type).endswith("CUDA"):
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    if not total:
        return None, 0
    return total / reps / 1e3, count / reps  # microseconds -> ms


def device_ms(fn, kernel: str = "", reps: int = 20):
    """``device_stats``' time alone."""
    return device_stats(fn, kernel, reps)[0]


def host_ms(fn, reps: int = 20) -> float:
    """Host time per call of ``fn`` (the wrapper's Python, checks,
    allocations and launches), on the host clock with no synchronisation
    inside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / reps * 1e3


def cold_copies(nbytes_one: int) -> int:
    """Copies of a call's operands that a rotation needs for every call to
    find its own evicted from the L2: between two uses of a copy, the
    others move more bytes than the L2 holds."""
    return 1 + -(-L2_BYTES // nbytes_one)


def rotation(fn, arg_sets):
    """A call of ``fn`` on the next argument tuple of ``arg_sets`` each
    time, round and round."""
    sets = itertools.cycle(arg_sets)
    return lambda: fn(*next(sets))


def time_cold(row: dict, fn, arg_sets, reps: int = 20) -> None:
    """Times ``fn`` over a rotation of ``arg_sets`` into ``row`` (a phase-3
    row): event ms (``ms``), device ms and kernel launches per call
    (``torch.profiler``), the wrapper's host ms per call, and the number of
    copies rotated."""
    call = rotation(fn, arg_sets)
    row["ms"] = timed_ms(call, reps=reps)
    row["device_ms"], row["launches_per_call"] = device_stats(call, reps=reps)
    row["host_ms"] = host_ms(call, reps=reps)
    row["copies"] = len(arg_sets)


def ids_digest(ids) -> str:
    """A short digest of generated ids, to hold them against another run's
    (the parent commit's, say) without printing them all."""
    return hashlib.sha1(json.dumps(ids).encode()).hexdigest()[:12]


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
        "library_ms": library_ms, "flops": flops, "bytes": bytes_moved,
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


def sdpa_cold_ms(q, kv_sets, mask=None, reps=20) -> float:
    """``sdpa_ms`` over a rotation of (k, v) copies (``cold_copies``)."""
    def call(k, v):
        k, v, kw = sdpa_operands(q, k, v)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **kw)
    return timed_ms(rotation(call, kv_sets), reps=reps)


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


def weight_copies(qw):
    """(q, scale) of ``qw`` and enough clones for a rotation that finds
    each call's weight evicted from the L2, as a decode step finds each
    layer's (``cold_copies``)."""
    return copies_of((qw.q, qw.scale), cold_copies(nbytes(qw.q, qw.scale)))


def check_int4(gen, results):
    """K1 at every decoder linear at decode (M 4), at one request's
    prefill, at the QLoRA step's M (2 x 2048) and at the batch-4 prefill,
    each on a weight of its own; on the M 4 rows' weights also at M 1, 9
    and 32 (32: a verify round's rows at batch 4), then at the slot pool's
    M 36 (a verify round of 4 slots, 9 rows each), 512 and 2048 (an
    admission of 4 questions at bucket 128, and at phase 9's bucket 512),
    x for those and the pool's weights from a
    generator of their own so that the shared one gives the later checks
    the inputs they always had. The GEMV rows are timed on a cold L2 over
    a rotation of weight copies."""
    extra = torch.Generator(device="cuda").manual_seed(4)
    if hasattr(qmm, "_gemv_capacity"):  # the cluster GEMV's package
        lib = _kernels.lib()
        modes = (("v1", 1), ("v1", 9), ("v1", 32), ("v3", 1), ("v3", 9),
                 ("glu", 1))
        if QUANTIZER_KERNEL:  # K7's and K6's GEMV on the same kernel
            modes += (("w4a8", 1), ("w4a8", 9), ("int8", 1), ("int8", 32))
        for mode, M in modes:
            print(f"int4 GEMV {mode} at M={M}: clusters of 1-8 blocks the "
                  f"card holds at once (group 64): "
                  f"{qmm._gemv_capacity(lib, 0, mode, M, 64)}")
    for M, g in ((4, gen), (1487, gen), (4096, gen), (4 * 1487, gen),
                 (36, extra), (512, extra), (2048, extra)):
        for K, N in LINEAR_SHAPES:
            qw = _quantize_leaf_int4(random_weight(K, N, g))
            kpad = qw.q.shape[0] * 2
            x4 = randn(M, K, gen=g)
            gemv = M <= qmm.GEMV_MAX_M
            copies = weight_copies(qw) if gemv else None
            for m in INT4_GEMV_MS if gemv else (M,):
                x = x4 if m == M else randn(m, K, gen=extra)
                x2 = F.pad(x, (0, kpad - K)).contiguous()
                got = int4_matmul(x, qw)
                want = int4_matmul(x, qw, impl="plain")
                err = compare(f"int4 M={m} K={K} N={N}", got, want)
                plain = timed_ms(lambda: int4_matmul_2d_plain(
                    x2, qw.q, qw.scale, qw.group), reps=1 if gemv else 3)
                # no single library call takes packed int4: dequantize +
                # matmul
                library = timed_ms(
                    lambda: x @ _dequantize_leaf(qw, torch.bfloat16), reps=3)
                record(results, "int4_matmul",
                       f"M={m} K={K}(pad {kpad}) N={N}", err, None, plain,
                       nbytes(x2, qw.q, qw.scale, got), 2 * m * kpad * N,
                       library)
                if gemv:
                    time_cold(results[-1], lambda q, s: int4_matmul_2d(
                        x2, q, s, qw.group), copies)
                else:
                    results[-1]["ms"] = timed_ms(lambda: int4_matmul_2d(
                        x2, qw.q, qw.scale, qw.group), reps=3)
            del copies

# Decoder linears of the 13B model: (K, N) of wq/wk/wv/wo, w1/w3, w2, head.
LINEAR_SHAPES = ((5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000))
GEMV_MS = (1, 4, 8, 32)        # decode batches and verify spans
INT4_GEMV_MS = (4, 1, 9, 32)   # K1's: both sides of an 8-row fragment
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
    """K6 at every decoder linear, K unpadded (13824 for w2); the GEMV rows
    (M <= 32) also on a cold L2 over a rotation of weight copies."""
    for K, N in LINEAR_SHAPES:
        qw = _quantize_leaf_int8(random_weight(K, N, gen))
        copies = weight_copies(qw)
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
            if M <= qmm.GEMV_MAX_M:
                time_cold(results[-1], lambda q, s: int8_matmul_2d(x, q, s),
                          copies)
        del copies


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
        copies = weight_copies(qw)
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
            if M <= qmm.GEMV_MAX_M:  # the GEMV on a cold L2
                time_cold(results[-1], lambda q, s: int4_matmul_2d_v3(
                    x, q, s, qw.group), copies)

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
                # the wrapper (the row quantizer, then the GEMV) on a cold
                # L2, and the GEMV alone
                time_cold(results[-1], lambda q, s: int4_matmul_2d_w4a8(
                    x, q, s, qw.group), copies)
                results[-1]["kernel_device_ms"] = device_stats(
                    rotation(lambda q, s: int4_matmul_2d_w4a8(
                        x, q, s, qw.group), copies), "gemv")[0]
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
                       f"M={M} {shape} rel_vs_exact={rel:.2e}", err, None,
                       timed_ms(lambda: int4_matmul_2d_w8a8p_plain(x, *wargs),
                                reps=1),
                       nbytes(x, qw.q, qw.scale, got), flops,
                       timed_ms(int_mm, reps), peak_ops=PEAK_INT8_OPS_PER_S)
                # the wrapper (the activation quantizer and the factors in
                # tensor ops, then the kernel) and the kernel alone, over
                # the rotation of weight copies
                call = rotation(lambda q, s: int4_matmul_2d_w8a8p(
                    x, q, s, qw.group), copies)
                time_cold(results[-1], lambda q, s: int4_matmul_2d_w8a8p(
                    x, q, s, qw.group), copies, reps=reps)
                results[-1]["kernel_device_ms"] = device_stats(
                    call, W8A8P_KERNEL, reps=reps)[0]
                del w8
        del copies


def check_quantizer(results):
    """The row quantizer at K7's shapes (M 1-32, K 5120 and the padded
    14336) and K8's (one request's prefill, M 1487), bit for bit against its
    plain version, inputs from a generator of their own (so the other
    checks see the inputs they always had). No single library call
    computes it: ``library_ms`` is None."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for M, K in ((1, 5120), (4, 5120), (32, 14336), (1487, 5120),
                 (1487, 14336)):
        x = randn(M, K, gen=gen)
        q, sc = quantize_act_int8(x)
        wq, ws = quantize_act_int8_plain(x)
        same = torch.equal(q, wq) and torch.equal(sc, ws)
        if not same:
            FAILURES.append(f"quantizer M={M} K={K}: differs from its plain "
                            f"version in {int((q != wq).sum())} of "
                            f"{q.numel()} values")
        err = float((q.float() - wq.float()).abs().max())
        reps = reps_for(M)
        record(results, "quantize_act_int8", f"M={M} K={K}", err,
               timed_ms(lambda: quantize_act_int8(x), reps=20),
               timed_ms(lambda: quantize_act_int8_plain(x), reps=reps),
               nbytes(x, q, sc), 0, None)
        row = results[-1]
        row["device_ms"], row["launches_per_call"] = device_stats(
            lambda: quantize_act_int8(x))
        row["host_ms"] = host_ms(lambda: quantize_act_int8(x))
        row["copies"] = 1


def check_glu(gen, results):
    """K11 at the FFN tail's shape (w2), and at the square one; the GEMV
    rows on a cold L2."""
    for K, N in ((13824, 5120), (5120, 5120)):
        qw = _quantize_leaf_int4(random_weight(K, N, gen))
        kpad = qw.q.shape[0] * 2
        copies = weight_copies(qw)
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
            if M <= qmm.GEMV_MAX_M:
                time_cold(results[-1], lambda q, s: int4_matmul_2d_glu(
                    g, u, q, s, res, qw.group), copies)
        del copies


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
    # the chunk shape on samples of their own (a generator per seed, as the
    # card test and scripts/torch_flash_chunk_seeds.py draw them): with the
    # softmax weights in bf16 alone, 12 of seeds 0-63 left the plain bound
    worst = 0.0
    for seed in range(16):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = randn(1, 40, 476, 128, gen=g)
        k, v = randn(1, 40, 1500, 128, gen=g), randn(1, 40, 1500, 128, gen=g)
        worst = max(worst, compare(
            f"flash chunk sample seed {seed}",
            flash_attention_bhsd(q, k, v, causal=True),
            flash_attention_bhsd_plain(q, k, v, causal=True)))
    print(f"flash B=1 Sq=476 Skv=1500, seeds 0-15: max_abs_err {worst:.3e} "
          f"(plain bound)")


# the prefix-cache admission of phase 9: a bucket of question tokens,
# right-aligned causal over the [BOS | image words] prefix (1456 rows) and
# the bucket itself, one request or a group of four: 16-128 for questions
# as a subword tokenizer cuts them, 512 for phase 9's own (278-281 ids a
# prompt from the synthetic tokenizer, about one a character)
PREFIX_ROWS = 1456
EXTENSION_SHAPES = ((1, 16), (1, 64), (1, 128), (4, 16), (4, 64), (4, 128),
                    (4, 512))


def check_flash_extension(gen, results):
    """K2 at the extension shapes, with the keys' extent passed as the
    cache dispatch passes it (``skv_actual``)."""
    D, H = 128, 40
    for B, Sq in EXTENSION_SHAPES:
        Skv = PREFIX_ROWS + Sq
        q = randn(B, H, Sq, D, gen=gen)
        k = randn(B, H, Skv, D, gen=gen)
        v = randn(B, H, Skv, D, gen=gen)
        got = flash_attention_bhsd(q, k, v, causal=True, skv_actual=Skv)
        want = flash_attention_bhsd_plain(q, k, v, causal=True,
                                          skv_actual=Skv)
        err = compare(f"flash extension B={B} Sq={Sq} Skv={Skv}", got, want)
        ms = timed_ms(lambda: flash_attention_bhsd(q, k, v, causal=True,
                                                   skv_actual=Skv))
        plain = timed_ms(lambda: flash_attention_bhsd_plain(
            q, k, v, causal=True, skv_actual=Skv))
        library = sdpa_ms(q, k, v, mask=right_aligned_mask(Sq, Skv))
        record(results, "flash_attention",
               f"extension B={B} Hq={H} Sq={Sq} Skv={Skv} D={D}", err, ms,
               plain, nbytes(q, k, v, got),
               4 * D * B * H * causal_pairs(Sq, Skv), library)


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


def copies_of(tensors, n):
    """``tensors`` and n - 1 clones of them, as a list of tuples."""
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def check_decode(gen, results):
    """K3 at the batch-4 serving shape (write + attend, bf16 cache), timed
    on a cold L2 with its write targets rotating."""
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
    caches = copies_of((ck1, cv1), cold_copies(nbytes(ck, cv)))
    plain = timed_ms(lambda: decode_attention_update_plain(
        q, ck2, cv2, nk, nv, pos, valid), reps=20)
    library = sdpa_cold_ms(q, caches, mask=valid_mask(valid, S))
    rows = int(valid.sum())
    record(results, "decode_attention", f"B={B} Hkv={Hkv} G={G} S={S} D={D}",
           err, None, plain,
           2 * rows * Hkv * D * 2 + nbytes(q, got) + 2 * nbytes(nk, nv),
           4 * D * Hkv * G * rows, library)
    time_cold(results[-1], lambda k, v: decode_attention_update(
        q, k, v, nk, nv, pos, valid), caches)


def check_latency_kernels(gen, results):
    """The decode and verify kernels of the latency path against their
    plain versions: the attend-only bf16 kernel (equal to the fused
    kernel's output bit for bit), the int8 kernels (the fused one leaving
    caches bit-identical to the plain version's) and the verify kernels at
    spans 2, 5, 8 and 16; batch 1 and 4, GQA, a cache length that is no
    multiple of a stage, ragged ``pos`` and ``valid``. Each row is timed
    on a cold L2 (a rotation of cache copies; the fused rows write into
    them), with its device time and launches per call from a
    ``torch.profiler`` trace and the wrapper's host time per call."""
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
        dense = copies_of((ck, cv), cold_copies(nbytes(ck, cv)))

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
        record(results, "decode_attention_attend", case, err, None,
               timed_ms(lambda: decode_attention_plain(q, c1, c2, valid),
                        reps=20),
               2 * rows * Hkv * D * 2 + nbytes(q, got),
               4 * D * Hq * rows,
               sdpa_cold_ms(qb, dense, mask=valid_mask(valid, S)))
        time_cold(results[-1], lambda k, v: decode_attention(q, k, v, valid),
                  dense)
        del c1, c2

        # int8 cache of the same values
        kq = QuantizedKV(*quantize_kv_tokens(ck.transpose(1, 2)))
        vq = QuantizedKV(*quantize_kv_tokens(cv.transpose(1, 2)))
        kd, vd = dequantize_kv(kq), dequantize_kv(vq)
        q8 = [(QuantizedKV(*k), QuantizedKV(*v)) for k, v in (
            (c[:2], c[2:]) for c in copies_of(
                (*kq, *vq), cold_copies(nbytes(*kq, *vq))))]
        deq = copies_of((kd, vd), cold_copies(nbytes(kd, vd)))
        q8_bytes = 2 * rows * Hkv * (D + 4) + nbytes(q, got)
        got = decode_attention_quant(q, kq, vq, valid)
        err = compare(f"int8 decode {case}", got,
                      decode_attention_quant_plain(q, kq, vq, valid))
        library = sdpa_cold_ms(qb, deq, mask=valid_mask(valid, S))
        record(results, "decode_attention_q8", case, err, None,
               timed_ms(lambda: decode_attention_quant_plain(q, kq, vq,
                                                             valid), reps=20),
               q8_bytes, 4 * D * Hq * rows, library)
        time_cold(results[-1], lambda k, v: decode_attention_quant(
            q, k, v, valid), q8)

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
        record(results, "decode_attention_q8_fused", case, err, None,
               timed_ms(lambda: decode_attention_update_quant_plain(
                   q, k2, v2, xk, xv, pos, valid), reps=20),
               q8_bytes + nbytes(xk, xv) + 2 * B * Hkv * (D + 4),
               4 * D * Hq * rows, library)
        time_cold(results[-1], lambda k, v: decode_attention_update_quant(
            q, k, v, xk, xv, pos, valid), q8)
        del k1, v1, k2, v2

        for span in (8, 2, 5, 16):  # 8 first: the latency path's draft_k
            qs = randn(B, span, Hq, D, gen=gen)
            qsb = qs.transpose(1, 2)
            mask = valid_mask(valid, S, span)
            seen = int(mask.sum())  # visible (row, column) pairs per head
            vcase = f"span={span} {case}"
            for name, fn, plain, caches, lib_caches, row_bytes in (
                    ("verify_attention", verify_attention,
                     verify_attention_plain, dense, dense, D * 2),
                    ("verify_attention_q8", verify_attention_quant,
                     verify_attention_quant_plain, q8, deq, D + 4)):
                k, v = caches[0]
                got = fn(qs, k, v, valid)
                err = compare(f"{name} {vcase}", got,
                              plain(qs, k, v, valid))
                record(results, name, vcase, err, None,
                       timed_ms(lambda: plain(qs, k, v, valid), reps=20),
                       2 * rows * Hkv * row_bytes + nbytes(qs, got),
                       4 * D * Hq * seen,
                       sdpa_cold_ms(qsb, lib_caches, mask=mask))
                # every kernel of the call: the verify kernel and its
                # combine pass (and any copy the wrapper launches)
                time_cold(results[-1],
                          lambda k, v: fn(qs, k, v, valid), caches)
        del dense, q8, deq


def check_vit(gen, results):
    """K10 at the three towers' shapes, 20 crops (batch 4) and 5 (one
    request), on q, k and v as the tower block gives them: split views of
    one [B, S, 3W] projection, read in place. The device's time alone is
    printed beside the row."""
    for B in (20, 5):
        for H, D in ((16, 64), (16, 88), (24, 64)):
            S = 257
            qkv = randn(B, S, 3 * H * D, gen=gen)
            q, k, v = (t.reshape(B, S, H, D)
                       for t in qkv.split(H * D, dim=-1))
            got = vit_attention(q, k, v)
            want = vit_attention_plain(q, k, v)
            err = compare(f"vit B={B} H={H} D={D}", got, want)
            ms = timed_ms(lambda: vit_attention(q, k, v), reps=20)
            plain = timed_ms(lambda: vit_attention_plain(q, k, v), reps=20)
            qb, kb, vb = (t.transpose(1, 2) for t in (q, k, v))
            record(results, "vit_attention", f"B={B} S={S} H={H} D={D}",
                   err, ms, plain, nbytes(q, k, v, got),
                   4 * B * H * S * S * D, sdpa_ms(qb, kb, vb, reps=20))
            # the device's time alone: at 5 crops the host's share of a
            # call is large
            dev = device_ms(lambda: vit_attention(q, k, v), "vit_attn_kernel")
            dev = "not measured" if dev is None else f"{dev:.4f} ms"
            print(f"vit_attention B={B} H={H} D={D}: device time {dev} a "
                  f"call (torch.profiler)")


def kernel_times(fn, reps: int) -> dict:
    """Device ms and launches per call of ``fn``, by kernel name, from a
    ``torch.profiler`` trace of ``reps`` calls (warm ``fn`` first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            out[e.key] = (t / reps / 1e3, e.count / reps)
    return out


def short_name(key: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    key = re.sub(r"^void ", "", key)
    key = key.replace("(anonymous namespace)::", "")
    key = re.sub(r"\(.*$", "", key)
    return key.split("::")[-1][:48]


def print_profile(card: str, label: str, times: dict, groups: dict) -> None:
    """One line: the device time of a call, each group's share (kernel
    names holding one of its substrings) and the six longest kernels."""
    total = sum(t for t, _ in times.values())
    parts = []
    for name, pats in groups.items():
        sel = [v for k, v in times.items() if any(q in k for q in pats)]
        parts.append(f"{name} {sum(t for t, _ in sel):.4f} ms in "
                     f"{sum(n for _, n in sel):g} launches")
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"[{card}] {label}: device {total:.4f} ms a call ("
          + "; ".join(parts) + "); longest: "
          + ", ".join(f"{short_name(k)} {t:.4f} ms x{n:g}"
                      for k, (t, n) in top))


STEP_GROUPS = {"GEMV": GEMV_KERNELS, "row quantizer": QUANTIZER_KERNELS,
               "decode attention": ("decode_cluster", "decode_attn")}


def decode_profile(card: str, label: str, model, prompts, images,
                   steps: int = 4) -> dict:
    """One decode step's device time by kernel name (``torch.profiler``
    over ``steps`` steps after one warm-up step) on a cache prefilled with
    the prompts' common prefix, the model's cache settings: the device
    work of a step without the host's eager loop around it."""
    from a3vlm_tpu_torch.models import llama
    from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype

    args, lp = model.args, model.params["llama"]
    with torch.inference_mode():
        img = model.encode_images(images)
        P = min(len(t) for t in prompts)
        tokens = torch.tensor([t[:P] for t in prompts], device="cuda")
        cache = llama.KVCache.create(
            args, len(prompts), P + img.shape[1] + steps + 2,
            dtype=kv_cache_dtype(model.kv_cache_bits, "cuda"), device="cuda")
        logits, cache, S = llama.prefill(lp, args, cache, tokens, img)
        tok = logits.argmax(-1)[:, None]
        pos = [S]

        def step():
            llama.decode_step(lp, args, cache, tok, pos[0])
            pos[0] += 1

        step()
        torch.cuda.synchronize()
        times = kernel_times(step, steps)
    print_profile(card, f"{label}: one decode step (torch.profiler over "
                  f"{steps} steps)", times, STEP_GROUPS)
    return times


def prefill_profile(card: str, label: str, model, prompts, images) -> dict:
    """One prefill's device time by kernel name, after a warm-up prefill,
    in the mode that is switched on."""
    from a3vlm_tpu_torch.models import llama

    args, lp = model.args, model.params["llama"]
    with torch.inference_mode():
        img = model.encode_images(images)
        P = min(len(t) for t in prompts)
        tokens = torch.tensor([t[:P] for t in prompts], device="cuda")
        cache = llama.KVCache.create(args, len(prompts), P + img.shape[1],
                                     dtype=torch.bfloat16, device="cuda")

        def prefill():
            llama.prefill(lp, args, cache, tokens, img)

        prefill()
        torch.cuda.synchronize()
        times = kernel_times(prefill, 1)
    print_profile(card, f"{label}: one prefill", times, {
        "W8A8 kernel (K8)": (W8A8P_KERNEL,),
        "row quantizer": QUANTIZER_KERNELS,
        "int4 tile (K1)": ("int4_mma_kernel",),
        "flash attention": ("flash_fwd",)})
    return times


def towers_profile(card: str, label: str, model, images) -> dict:
    """One call of the towers' device time by kernel name, after a warm-up
    call, with the towers as they are quantized."""
    with torch.inference_mode():
        model.encode_images(images)
        torch.cuda.synchronize()
        times = kernel_times(lambda: model.encode_images(images), 1)
    print_profile(card, f"{label}: the towers", times, {
        "row quantizer": QUANTIZER_KERNELS,
        "tower attention (K10)": ("vit_attn",)})
    return times


def require_no_fallback(card: str, path: str) -> None:
    """No dispatcher call so far took a reference route: every full-width
    shape lies in the kernels' domain (a parent tree without the routes
    counts none)."""
    count = qmm.fallback_count() if hasattr(qmm, "fallback_count") else 0
    print(f"[{card}] {path}: calls on a fallback route {count}")
    if count:
        raise AssertionError(
            f"{path}: {count} quantized-matmul calls took a fallback route "
            f"(int4 {qmm.int4_matmul.fallbacks}, int8 "
            f"{qmm.int8_matmul.fallbacks})")


# Generated ids of every labelled run, for ``--ids-out``; ``--ids-ref``
# loads another run's (the parent commit's, say) to hold them against.
IDS: dict = {}
IDS_REF: dict = {}


def logit_gap(model, prompts, images, outs, row: int, at: int):
    """The vanilla loop replayed on the kernel path with the model's cache
    and prefill settings, the run's ids forced, up to the logits that chose
    generated id ``at`` of ``row``: (their top-2 gap, the max |kernel -
    plain| of that step's logits, the plain step on a copy of the same
    cache, and the replay's own choice)."""
    from a3vlm_tpu_torch.generation import _prefill_bucket
    from a3vlm_tpu_torch.models import llama
    from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype

    gen = model._get_generator()
    args, B = gen.args, len(prompts)
    with torch.inference_mode():
        img = model.encode_images(images)
        W = img.shape[1]
        P = _prefill_bucket(min(len(t) for t in prompts))
        target = len(prompts[row]) + at  # the position that id fills
        L = max(target, P) + 1
        toks = torch.zeros((B, L), dtype=torch.long)
        for i, (t, o) in enumerate(zip(prompts, outs)):
            seq = (list(t) + list(o))[:L]
            toks[i, :len(seq)] = torch.tensor(seq)
        toks = toks.to("cuda")

        def new_cache():
            return llama.KVCache.create(
                args, B, L + W, dtype=kv_cache_dtype(gen.kv_cache_bits,
                                                     "cuda"), device="cuda")

        kernel, cache, _ = gen._prefill(new_cache(), toks[:, :P], img, "auto")
        if target == P:
            plain = gen._prefill(new_cache(), toks[:, :P], img, "plain")[0]
        else:
            for pos in range(P, target):
                if pos == target - 1:
                    plain = llama.decode_step(gen.params, args,
                                              clone_cache(cache),
                                              toks[:, pos:pos + 1], pos + W,
                                              "plain")[0]
                kernel, cache = llama.decode_step(
                    gen.params, args, cache, toks[:, pos:pos + 1], pos + W,
                    "auto")
        limit = gen.vocab_limit or kernel.shape[-1]
        top = kernel[row, :limit].float().topk(2)
        return (float(top.values[0] - top.values[1]),
                float((kernel[row] - plain[row]).float().abs().max()),
                int(top.indices[0]))


def note_ids(card: str, label: str, outs, replay=None) -> None:
    """Keeps a run's ids under ``label``; where ``--ids-ref`` has other ids
    for it, prints the first differing row and index and, with ``replay``
    (model, prompts, images) of a vanilla-loop run, this run's top-2 logit gap
    there against the kernel-vs-plain logit error of the same step: a flip
    between two summation orders is explained when the gap is no larger
    than that error."""
    IDS[label] = outs
    ref = IDS_REF.get(label)
    if ref is None:
        return
    if ref == outs:
        print(f"[{card}] ids {label}: equal to the reference run's")
        return
    row = next(i for i, (a, b) in enumerate(zip(outs, ref)) if a != b)
    at = first_difference(outs[row], ref[row])
    mine = outs[row][at] if at < len(outs[row]) else None
    theirs = ref[row][at] if at < len(ref[row]) else None
    line = (f"[{card}] ids {label}: first differ from the reference run's "
            f"at row {row} index {at} (this run {mine}, reference {theirs})")
    if replay is not None and mine is not None and theirs is not None:
        gap, err, pick = logit_gap(*replay, outs, row, at)
        line += (f"; this run's top-2 logit gap there {gap:.4f} (the "
                 f"replay picks {pick}), kernel vs plain max |logit diff| "
                 f"of that step {err:.4f}")
    print(line)


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


def serving_inputs():
    """Phase 4's four requests, made from a seed: prompts of 37, 41, 45
    and 52 ids and 448x448 images (CLIP-normalized, bf16)."""
    from a3vlm_tpu_torch.models import ens5

    gen = torch.Generator(device="cuda").manual_seed(1)
    mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
    std = torch.tensor(ens5.CLIP_STD, device="cuda")
    pixels = torch.rand(4, 448, 448, 3, generator=gen, device="cuda")
    images = ((pixels - mean) / std).to(torch.bfloat16)
    prompts = [
        [1] + torch.randint(3, 32000, (n - 1,), generator=gen,
                            device="cuda").tolist()
        for n in (37, 41, 45, 52)
    ]
    return prompts, images


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
        dtype=torch.bfloat16, tokenizer=_PieceTable(32000), model_cfg=cfg,
        seed=0,
    )
    model.quantize(bits=4)
    torch.cuda.synchronize()
    print(f"[{card}] model built (random weights, int4 decoder) in "
          f"{time.perf_counter() - t0:.1f} s")

    prompts, images = serving_inputs()
    lengths = [len(p) for p in prompts]

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
    print(f"[{card}] generated lengths {[len(o) for o in outs]}, ids "
          f"digest {ids_digest(outs)}")
    note_ids(card, "serve", outs, (model, prompts, images))
    decode_profile(card, "serving, batch 4", model, prompts, images)

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
    """A synthetic tokenizer table: ids 0..2 are specials (id 1 BOS, id 2
    EOS), then one piece per character the triad grammars use, then every
    two-digit string, then one piece per other printable character, then
    pieces no text holds, up to ``n_words``. It serves
    ``constrained.compile_grammar`` (``id_to_piece``) and the text path
    (``encode``, ``decode``, ``encode_segment``, ``encode_wo_prefix_space``):
    encoding takes the longest piece at each position. ``decoded`` keeps
    every id list ``decode`` was given, when it is a list."""

    def __init__(self, n_words: int):
        chars = "0123456789.,[]<>/- abcdefghijklmnopqrstuvwxyz_:"
        pieces = ["", "", ""] + list(chars)
        pieces += [f"{a}{b}" for a in "0123456789" for b in "0123456789"]
        pieces += [chr(c) for c in range(32, 127) if chr(c) not in chars]
        pieces += ["\n", "\t"]
        pieces += [f"~{i}" for i in range(n_words - len(pieces))]
        self.pieces = pieces
        self.n_words = n_words
        self.bos_id = 1
        self.eos_id = 2
        self._ids = {p: i for i, p in enumerate(pieces) if p}
        self._longest = max(len(p) for p in pieces)
        self.decoded = None

    def id_to_piece(self, t: int) -> str:
        return self.pieces[t]

    def encode(self, s: str, bos: bool, eos: bool) -> list[int]:
        ids, i = [], 0
        while i < len(s):
            for n in range(min(self._longest, len(s) - i), 0, -1):
                t = self._ids.get(s[i:i + n])
                if t is not None:
                    ids.append(t)
                    i += n
                    break
            else:  # a character the table lacks: unknown, id 0
                ids.append(0)
                i += 1
        return [self.bos_id] * bos + ids + [self.eos_id] * eos

    def encode_segment(self, s: str) -> list[int]:
        return self.encode(s, bos=False, eos=False)

    def encode_wo_prefix_space(self, s: str) -> list[int]:
        return self.encode(s, bos=False, eos=False)

    def decode(self, ids) -> str:
        if self.decoded is not None:
            self.decoded.append(list(ids))
        return "".join(self.pieces[t] for t in ids)

    def save(self, save_dir: str) -> None:
        """The table as a checkpoint's tokenizer file (the surface
        ``CheckpointManager.save`` and the merge tool call)."""
        with open(f"{save_dir}/piece_table.json", "w") as f:
            json.dump(self.pieces, f)


EVAL_QUESTIONS = (
    "Please provide the joint's type and its 2D rotated bounding box linked "
    "to the object part door",
    "Please provide the joint's type and its 2D rotated bounding box linked "
    "to the object part drawer",
    "Please provide the joint's type and its 2D rotated bounding box linked "
    "to the object part lid",
    "<image>\nPlease provide the joint's type and its 2D rotated bounding "
    "box linked to the object part handle",
)
EVAL_ANSWER = re.compile(r"\s?<rb>(revolute|prismatic|fixed|continuous)</rb>"
                         r"\[-?\d{1,3}\.\d\d(,-?\d{1,3}\.\d\d){4}\]")
EVAL_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                "vit_attention")


def write_eval_tasks(root, card: str) -> str:
    """Phase 8's task file: 2 images x 4 questions, made from a seed. PNG
    at 640x480 where Pillow imports, else point clouds (``.npy``, xyz +
    rgb), which ``VQADataset`` renders to an image; the file name routes
    ``fsm_for_task`` to the joint grammar."""
    import numpy as np

    rng = np.random.default_rng(8)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    paths = []
    for i in range(2):
        if Image is not None:
            path = root / f"object{i}.png"
            pixels = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
            Image.fromarray(pixels).save(path)
        else:
            path = root / f"object{i}.npy"
            cloud = rng.uniform(-1, 1, (8192, 6)).astype(np.float32)
            cloud[:, 3:] = rng.uniform(0, 1, (8192, 3))
            np.save(path, cloud)
        paths.append(str(path))
    print(f"[{card}] eval task images: "
          + ("PNG 640x480" if Image is not None else "point clouds (.npy)"))
    task = root / "joint_rec_tasks.json"
    task.write_text(json.dumps([
        {"image": p, "conversations": [
            {"from": "human", "value": q},
            {"from": "gpt", "value": "<rb>revolute</rb>"
             "[0.50,0.50,0.30,0.20,0.00]"}]}
        for p in paths for q in EVAL_QUESTIONS]))
    return str(task)


def write_decoder_checkpoint(root):
    """A full-width decoder cut to 2 layers (bf16, weights from a seed) as
    a consolidated checkpoint under ``root / "ckpt"``, written with
    ``torch.save`` beside its ``meta.json`` and ``config.json``. Returns
    the directory and the state dict (on the card)."""
    from a3vlm_tpu_torch.config import ModelArgs

    args = ModelArgs(n_layers=2, vocab_size=32000)
    D, F_, V = args.dim, args.ffn_hidden_dim, args.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = {"tok_embeddings.weight": (V, D), "norm.weight": (D,),
              "output.weight": (V, D)}
    for i in range(args.n_layers):
        for w in ("wq", "wk", "wv", "wo"):
            shapes[f"layers.{i}.attention.{w}.weight"] = (D, D)
        for w, shape in (("w1", (F_, D)), ("w2", (D, F_)), ("w3", (F_, D))):
            shapes[f"layers.{i}.feed_forward.{w}.weight"] = shape
        for n in ("attention_norm", "ffn_norm"):
            shapes[f"layers.{i}.{n}.weight"] = (D,)
    sd = {f"llma.{k}": torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for k, shape in shapes.items()}
    ckpt = root / "ckpt"
    ckpt.mkdir()
    torch.save({"model": {k: v.cpu() for k, v in sd.items()}},
               ckpt / "consolidated.00-of-01.model.pth")
    (ckpt / "meta.json").write_text(json.dumps({"llama_type": "llama_ens5"}))
    (ckpt / "config.json").write_text(json.dumps(
        {"dim": D, "multiple_of": args.multiple_of, "n_heads": args.n_heads,
         "n_layers": args.n_layers, "norm_eps": args.norm_eps,
         "vocab_size": -1}))
    return ckpt, sd


def run_checkpoint_path(card: str, root, task: str, ds) -> dict:
    """A consolidated checkpoint of a full-width decoder cut to 2 layers
    (bf16, weights from a seed) written with ``torch.save`` beside its
    ``meta.json`` and ``config.json``, then loaded as a user loads it:
    ``MetaModel.from_pretrained(..., device="cuda")`` (the checkpoint holds
    no towers, so the random towers stay and the random decoder is freed
    before the loaded one lands), every decoder leaf equal to what was
    written (linears transposed to [in, out]); then the CLI,
    ``eval_affordance.main`` with ``--device cuda --quant --score``, on
    that checkpoint over the task file, its records in order and in the
    schema. Returns the CLI run's launch counts."""
    from a3vlm_tpu_torch.eval_affordance import _question_of
    from a3vlm_tpu_torch.eval_affordance import main as eval_main
    from a3vlm_tpu_torch.meta import MetaModel

    ckpt, sd = write_decoder_checkpoint(root)
    V = 32000
    t0 = time.perf_counter()
    model = MetaModel.from_pretrained(str(ckpt), with_visual=True,
                                      device="cuda",
                                      tokenizer=_PieceTable(V))
    synchronize(model.device)
    secs = time.perf_counter() - t0
    params = model.params["llama"]
    checked = 0

    def hold(got, key, transpose):
        nonlocal checked
        want = sd[f"llma.{key}"]
        want = want.t() if transpose else want
        if (got.device != want.device or got.dtype != torch.bfloat16
                or not torch.equal(got, want)):
            raise AssertionError(f"from_pretrained: {key} differs")
        checked += 1

    hold(params["tok_embeddings"]["weight"], "tok_embeddings.weight", False)
    hold(params["norm"]["weight"], "norm.weight", False)
    hold(params["output"]["weight"], "output.weight", True)
    for i, lp in enumerate(params["layers"]):
        for group, names in (("attention", ("wq", "wk", "wv", "wo")),
                             ("feed_forward", ("w1", "w2", "w3"))):
            for w in names:
                hold(lp[group][w]["weight"], f"layers.{i}.{group}.{w}.weight",
                     True)
        for n in ("attention_norm", "ffn_norm"):
            hold(lp[n]["weight"], f"layers.{i}.{n}.weight", False)
    size = sum(v.numel() * 2 for v in sd.values()) / 2 ** 30
    print(f"[{card}] from_pretrained (dim {model.args.dim}, "
          f"{len(params['layers'])} "
          f"layers, vocab {V}, {size:.2f} GiB bf16, random towers): "
          f"{checked} of {len(sd)} decoder leaves on the card equal to what "
          f"was written; load + import + to the card {secs:.1f} s")
    if checked != len(sd):
        raise AssertionError("from_pretrained: leaves missing")
    del model, params, sd
    gc.collect()
    torch.cuda.empty_cache()

    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    reset_launches()
    t0 = time.perf_counter()
    results = eval_main(
        ["--pretrained_path", str(ckpt), "--dataset", task, "--output_dir",
         str(root / "cli"), "--batch_size", "4", "--max_gen_len", "8",
         "--temperature", "0", "--quant", "--score", "--device", "cuda"],
        tokenizer=_PieceTable(V))
    secs = time.perf_counter() - t0
    launches = {n: KERNELS[n][2].launches for n in KERNELS}
    require_counts(launches, EVAL_KERNELS, "eval CLI")
    require_no_fallback(card, "eval CLI")
    with open(results) as f:
        records = json.load(f)
    keys = {"answer", "format_answer", "annotation", "question", "image",
            "fail"}
    if [(r["image"], r["question"]) for r in records] != [
            (d["image"], _question_of(d)) for d in ds.data] or any(
                set(r) != keys for r in records):
        raise AssertionError("eval CLI: records out of order or schema")
    print(f"[{card}] eval CLI (--device cuda --quant --score, 2-layer "
          f"checkpoint): {len(records)} records in order, {secs:.1f} s "
          f"with the load; launches "
          f"{ {n: launches[n] for n in EVAL_KERNELS} }")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_eval_path(card: str, model):
    """Phase 8: the eval CLI's path on phase 4's model, then on a
    checkpoint of its own. Returns the eval kernels' launch counts of the
    two ``run_eval`` runs and the CLI run, and each run's (wall ms,
    records) by label, which phase 9 is held beside."""
    import numpy as np

    from a3vlm_tpu_torch.codecs.triad import (parse_rotated_box,
                                              parse_tagged_answer)
    from a3vlm_tpu_torch.constrained import fsm_for_task
    from a3vlm_tpu_torch.data.conversation import conv_templates
    from a3vlm_tpu_torch.eval_affordance import (VQADataset, _question_of,
                                                 run_eval)
    from a3vlm_tpu_torch.tools.score_results import main as score_main

    for mod in ("PIL", "transformers", "tokenizers", "sentencepiece"):
        try:
            __import__(mod)
            found = "imports"
        except ImportError:
            found = "missing"
        print(f"[{card}] eval: package {mod} {found}")
    tok = model.tokenizer
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        task = write_eval_tasks(root, card)
        ds = VQADataset(task, input_size=448)
        device = model.device
        t0 = time.perf_counter()
        fsm = fsm_for_task(Path(task).stem, tok)
        print(f"[{card}] eval: grammar of {Path(task).stem}: "
              f"{fsm.n_states} states, compiled in "
              f"{time.perf_counter() - t0:.1f} s")

        class Timed:
            """``model`` as run_eval sees it, timing each batch's call."""

            def __init__(self):
                self.rows = []

            def generate(self, prompts, **kw):
                synchronize(device)
                t = time.perf_counter()
                out = model.generate(prompts, **kw)
                synchronize(device)
                self.rows.append(((time.perf_counter() - t) * 1e3,
                                  dict(model.last_stats)))
                return out

        # warm-up batch (library plans, the allocator), then the runs
        run_eval(model, ds, batch_size=4, max_gen_len=2, temperature=0.0)
        if hasattr(qmm, "reset_fallbacks"):
            qmm.reset_fallbacks()
        totals = {n: 0 for n in KERNELS}
        runs, lockstep = {}, {}
        for label, fsm_, n_new in (("unconstrained", None, 32),
                                   ("grammar", fsm, 64)):
            timed = Timed()
            tok.decoded = []
            reset_launches()
            synchronize(device)
            t0 = time.perf_counter()
            records = run_eval(timed, ds, batch_size=4, max_gen_len=n_new,
                               temperature=0.0, fsm=fsm_)
            synchronize(device)
            lockstep[label] = ((time.perf_counter() - t0) * 1e3, records)
            launches = {n: KERNELS[n][2].launches for n in KERNELS}
            for n, c in launches.items():
                totals[n] += c
            require_counts(launches, EVAL_KERNELS, f"eval ({label})")
            ids, tok.decoded = tok.decoded, None
            runs[label] = (records, ids)
            for b, (ms, st) in enumerate(timed.rows):
                print(f"[{card}] eval {label} batch {b} of 4: wall "
                      f"{ms:.1f} ms, towers {st['towers_ms']:.1f} ms, "
                      f"prefill {st['prefill_ms']:.1f} ms, decode "
                      f"{st['decode_ms']:.1f} ms over {st['decode_steps']} "
                      f"steps; tokens "
                      f"{[len(x) for x in ids[4 * b: 4 * b + 4]]}")
            print(f"[{card}] eval {label}: launches "
                  f"{ {n: launches[n] for n in EVAL_KERNELS} }, ids digest "
                  f"{ids_digest(ids)}")
        require_no_fallback(card, "eval")

        # the text path's ids against the token-id path's, batch by batch
        records, ids = runs["unconstrained"]
        sep = conv_templates["v1"]().response_end_signal
        stops = [(tok.eos_id,), tuple(tok.encode_segment(sep)),
                 tuple(tok.encode_wo_prefix_space(sep))]
        for b in range(0, len(ds), 4):
            items = [ds[i] for i in range(b, min(b + 4, len(ds)))]
            images = torch.tensor(np.stack([it["image"] for it in items]),
                                  device=device).to(
                model.params["start_img"].dtype)
            want = model.generate_tokens(
                [tok.encode(it["prompt"], bos=True, eos=False)
                 for it in items], images=images, max_gen_len=32,
                temperature=0.0, stop_tokens=stops)
            if want != ids[b: b + 4]:
                raise AssertionError(
                    f"eval batch {b // 4}: run_eval's ids differ from "
                    "generate_tokens' on the same prompts and images")
        print(f"[{card}] eval unconstrained: run_eval's ids equal "
              "generate_tokens' on the same prompts and images")

        # the grammar run: every answer a complete joint triad
        g_records, g_ids = runs["grammar"]
        for rec, raw_ids in zip(g_records, g_ids):
            raw = tok.decode(raw_ids)
            tag, _, rest = parse_tagged_answer(raw)
            box = parse_rotated_box(rest)
            if (not EVAL_ANSWER.fullmatch(raw) or tag != "rb"
                    or box is None or len(box) != 5
                    or len(rec["format_answer"]) != 5):
                raise AssertionError(f"eval grammar: answer {raw!r} does "
                                     "not parse as a joint triad")
        print(f"[{card}] eval grammar: {len(g_records)} of "
              f"{len(g_records)} answers parse as joint triads "
              f"(e.g. {tok.decode(g_ids[0])!r}); fail flags "
              f"{sum(r['fail'] for r in g_records)} (the reference's check "
              "wants a 4-number 2-D box; a rotated box has 5)")

        # the results file: written, read back, held to the schema, scored
        results = root / "results_joint_rec_tasks.json"
        with open(results, "w") as f:
            json.dump(records, f, ensure_ascii=False)
        with open(results) as f:
            back = json.load(f)
        keys = {"answer", "format_answer", "annotation", "question", "image",
                "fail"}
        if back != records or len(back) != len(ds) or any(
                set(r) != keys or not isinstance(r["fail"], bool)
                or not isinstance(r["answer"], str)
                or not all(isinstance(x, float) for x in r["format_answer"])
                for r in back):
            raise AssertionError("eval results file: schema or content")
        if [(r["image"], r["question"]) for r in back] != [
                (d["image"], _question_of(d)) for d in ds.data]:
            raise AssertionError("eval results file: records out of order")
        summary = score_main([str(results)])
        # the copy scores ``answer`` where ``format_answer`` is the
        # repaired list, on which the original raises: the same records
        # with ``format_answer`` taken out, which the original can score,
        # must score the same
        stripped = root / "results_stripped.json"
        stripped.write_text(json.dumps(
            [{k: v for k, v in r.items() if k != "format_answer"}
             for r in records]))
        if json.dumps(score_main([str(stripped)]), sort_keys=True) != \
                json.dumps(summary, sort_keys=True):
            raise AssertionError("eval results: the scores differ with "
                                 "format_answer taken out")
        print(f"[{card}] eval results: {len(back)} records, schema held; "
              f"scored: { {k: v['n'] for k, v in summary.items()} }, the "
              "same with format_answer taken out")
        for n, c in run_checkpoint_path(card, root, task, ds).items():
            totals[n] += c
    return totals, lockstep


CB_KERNELS = ("int4_matmul", "flash_attention", "vit_attention")


class _TimedBatcher(serving_batch.ContinuousBatcher):
    """The batcher ``run_eval_continuous`` builds (phase 9 puts this class
    in its place), each stage timed on the host clock between device
    synchronisations into ``log``, and each generate call's raw ids (stop
    tokens included) kept there. ``spd`` is the ``steps_per_dispatch`` of
    every batcher built."""

    spd = 1
    log: list = []

    def __init__(self, *args, **kw):
        kw.setdefault("steps_per_dispatch", _TimedBatcher.spd)
        super().__init__(*args, **kw)
        self._warming = False

    def _timed(self, fn, *args):
        synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(self.device)
        return out, (time.perf_counter() - t0) * 1e3

    def warmup(self, *args, **kw):
        self._warming = True
        _, ms = self._timed(lambda: super(_TimedBatcher, self).warmup(
            *args, **kw))
        self._warming = False
        self.log.append(("warmup", ms))

    def _encode_image(self, image):
        out, ms = self._timed(super()._encode_image, image)
        self.log.append(("towers", ms))
        return out

    def make_prefix(self, image=None, tokens=None):
        out, ms = self._timed(super().make_prefix, image, tokens)
        self.log.append(("prefix", ms))
        return out

    def _admit_many(self, items):
        out, ms = self._timed(super()._admit_many, items)
        if not self._warming:
            self.log.append(("admit", ms))
        return out

    def _build_stats(self, t0, out_tokens):
        stats = super()._build_stats(t0, out_tokens)
        self.log.append(("generate", [list(out_tokens[i])
                                      for i in sorted(out_tokens)], stats,
                         self.steps))
        return stats


def pct(vals, q):
    """The batcher's percentile rule (nearest rank)."""
    v = sorted(vals)
    return v[min(int(q * (len(v) - 1) + 0.5), len(v) - 1)]


def cb_report(card: str, label: str, log: list, wall_ms: float) -> list:
    """Prints one phase-9 run's stages from its ``_TimedBatcher.log``:
    per image the towers and the prefix prefill, the admissions, then the
    decode steps, ms a step, tokens, and TTFT / TPOT p50 and p90 over the
    run's requests. Returns the run's raw ids, request by request."""
    ids, per, steps0, towers, admit = [], [], 0, 0.0, []
    warm = sum(e[1] for e in log if e[0] == "warmup")
    image = 0
    for entry in log:
        kind = entry[0]
        if kind == "towers":
            towers = entry[1]
        elif kind == "prefix":
            prefix = entry[1]
        elif kind == "admit":
            admit.append(entry[1])
        elif kind == "generate":
            _, rows, stats, steps = entry
            ids += rows
            per += stats["per_request"]
            n_steps = steps - steps0
            steps0 = steps
            decode = stats["total_s"] * 1e3 - sum(admit)
            print(f"[{card}] cb {label}, image {image}: prefix "
                  f"{prefix:.1f} ms (towers {towers:.1f} + prefill "
                  f"{prefix - towers:.1f}); admission "
                  f"{' + '.join(f'{a:.1f}' for a in admit)} ms; decode "
                  f"{decode:.1f} ms over {n_steps} steps = "
                  f"{decode / max(n_steps, 1):.2f} ms a step; tokens "
                  f"{[len(r) for r in rows]}")
            image, admit = image + 1, []
    ttft = [p["ttft_s"] * 1e3 for p in per]
    tpot = [p["tpot_ms"] for p in per if p["tokens"] > 1] or [0.0]
    print(f"[{card}] cb {label}: wall {wall_ms:.1f} ms for {len(ids)} "
          f"items (warmup {warm:.1f} ms of it); TTFT p50 "
          f"{pct(ttft, 0.5):.1f} p90 {pct(ttft, 0.9):.1f} ms, TPOT p50 "
          f"{pct(tpot, 0.5):.2f} p90 {pct(tpot, 0.9):.2f} ms; ids digest "
          f"{ids_digest(ids)}")
    return ids


def cb_logit_gap(model, item, ids: list, at: int):
    """The kernel path's top-2 logit gap where id ``at`` of a request was
    chosen, and the max |kernel - plain| of those logits: a prefill of
    [BOS | image | prompt + ids[:at]] through each path on the same image
    tokens (the position a decode step or a verify window chose it at)."""
    from a3vlm_tpu_torch.models import llama

    tok = model.tokenizer
    toks = tok.encode(item["prompt"], bos=True, eos=False) + list(ids[:at])
    with torch.inference_mode():
        image = torch.tensor(item["image"][None], device=model.device).to(
            model.params["start_img"].dtype)
        img = model.encode_images(image)
        logits = {}
        for impl in ("auto", "plain"):
            cache = llama.KVCache.create(model.args, 1,
                                         len(toks) + img.shape[1],
                                         dtype=img.dtype, device=model.device)
            logits[impl] = llama.prefill(
                model.params["llama"], model.args, cache,
                torch.tensor([toks], device=model.device), img,
                impl)[0][0, :model.true_vocab]
            del cache
    top = logits["auto"].topk(2).values
    return (float(top[0] - top[1]),
            float((logits["auto"] - logits["plain"]).abs().max()))


def hold_speculative(card: str, label: str, ids: list, ref: list, ref_label,
                     model, ds) -> None:
    """Prints how many requests' ids differ from the reference run's and,
    at the first differing id, the kernel path's top-2 logit gap beside
    its kernel-vs-plain logit error there; a gap above that error fails
    (the two runs then chose differently where the logits are clear)."""
    rows = [i for i, (a, b) in enumerate(zip(ids, ref)) if a != b]
    line = (f"[{card}] cb {label}: {len(rows)} of {len(ids)} requests' ids "
            f"differ from ({ref_label})'s")
    if rows:
        row = rows[0]
        at = first_difference(ids[row], ref[row])
        gap, err = cb_logit_gap(model, ds[row], ref[row], at)
        line += (f"; first at request {row} id {at}: top-2 logit gap "
                 f"{gap:.4f}, kernel vs plain max |logit diff| {err:.4f}")
        if gap > err:
            raise AssertionError(line + ": the gap exceeds the error")
    print(line)


def run_cb_path(card: str, model, lockstep: dict) -> dict:
    """Phase 9: continuous batching on phase 4's model. Returns the kernels'
    launch counts over runs (a)-(f)."""
    from a3vlm_tpu_torch.codecs.triad import (parse_rotated_box,
                                              parse_tagged_answer)
    from a3vlm_tpu_torch.constrained import fsm_for_task
    from a3vlm_tpu_torch.data.conversation import conv_templates
    from a3vlm_tpu_torch.eval_affordance import (VQADataset, _question_of,
                                                 run_eval_continuous)
    from a3vlm_tpu_torch.models import llama

    tok, args = model.tokenizer, model.args
    per_row = args.n_layers * 2 * args.kv_heads * args.head_dim * 2
    pool = 4 * (args.max_seq_len + 9) * per_row
    print(f"[{card}] cb: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated before phase 9; a pool of 4 x ({args.max_seq_len} + "
          f"9) rows takes {pool / 2**30:.2f} GiB (bf16, draft_k 8), a "
          f"[BOS | image words] prefix "
          f"{(1 + model.cfg.image_words) * per_row / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    totals = {n: 0 for n in KERNELS}
    sep = conv_templates["v1"]().response_end_signal
    keys = {"answer", "format_answer", "annotation", "question", "image",
            "fail"}
    real = serving_batch.ContinuousBatcher
    serving_batch.ContinuousBatcher = _TimedBatcher
    try:
        with tempfile.TemporaryDirectory() as tmp:
            task = write_eval_tasks(Path(tmp), card)
            ds = VQADataset(task, input_size=model.cfg.image_size)
            fsm = fsm_for_task(Path(task).stem, tok)
            runs = {}
            # label: (run_eval_continuous options, int8 cache, steps a
            # dispatch, the kernels it must launch beside CB_KERNELS)
            for label, kw, kv8, spd, need in (
                    ("a", dict(max_gen_len=32), False, 1,
                     ("decode_attention",)),
                    ("b", dict(max_gen_len=64, fsm=fsm), False, 1,
                     ("decode_attention",)),
                    ("c", dict(max_gen_len=32, draft_k=8), False, 1,
                     ("verify_attention",)),
                    ("d", dict(max_gen_len=32), True, 1,
                     ("decode_attention_q8_fused",)),
                    ("d8", dict(max_gen_len=32, draft_k=8), True, 1,
                     ("verify_attention_q8",)),
                    ("e", dict(max_gen_len=32), False, 8,
                     ("decode_attention",))):
                model.kv_cache_bits = 8 if kv8 else None
                _TimedBatcher.spd = spd
                _TimedBatcher.log = []
                reset_launches()
                synchronize(model.device)
                t0 = time.perf_counter()
                records = run_eval_continuous(model, ds, batch_size=4,
                                              temperature=0.0, **kw)
                synchronize(model.device)
                wall = (time.perf_counter() - t0) * 1e3
                launches = {n: KERNELS[n][2].launches for n in KERNELS}
                for n, c in launches.items():
                    totals[n] += c
                require_counts(launches, CB_KERNELS + need, f"cb ({label})")
                name = {"a": "(a) greedy", "b": "(b) grammar",
                        "c": "(c) draft_k 8", "d": "(d) int8 cache",
                        "d8": "(d) int8 cache, draft_k 8",
                        "e": "(e) steps_per_dispatch 8"}[label]
                ids = cb_report(card, name, _TimedBatcher.log, wall)
                print(f"[{card}] cb {name}: launches "
                      f"{ {n: c for n, c in launches.items() if c} }")
                if [(r["image"], r["question"]) for r in records] != [
                        (d["image"], _question_of(d)) for d in ds.data] or \
                        any(set(r) != keys for r in records):
                    raise AssertionError(f"cb {name}: records out of order "
                                         "or schema")
                runs[label] = (records, ids, wall)
            model.kv_cache_bits = None

            # exact agreement where the same kernels see the same operands
            if runs["e"][1] != runs["a"][1]:
                raise AssertionError("cb (e): ids differ from (a)'s")
            print(f"[{card}] cb (e) steps_per_dispatch 8: ids equal (a)'s")
            hold_speculative(card, "(c) draft_k 8", runs["c"][1],
                             runs["a"][1], "a", model, ds)
            hold_speculative(card, "(d) int8 cache, draft_k 8",
                             runs["d8"][1], runs["d"][1], "d int8 cache",
                             model, ds)
            differ = sum(a != b for a, b in zip(runs["d"][1], runs["a"][1]))
            print(f"[{card}] cb (d) int8 cache: {differ} of 8 requests' ids "
                  "differ from (a)'s (the cache's quantization)")

            # the grammar run: every answer a complete joint triad
            for rec, raw_ids in zip(*runs["b"][:2]):
                if tok.eos_id in raw_ids:
                    raw_ids = raw_ids[: raw_ids.index(tok.eos_id)]
                raw = tok.decode(raw_ids)
                tag, _, rest = parse_tagged_answer(raw)
                box = parse_rotated_box(rest)
                if (not EVAL_ANSWER.fullmatch(raw) or tag != "rb"
                        or box is None or len(box) != 5
                        or len(rec["format_answer"]) != 5):
                    raise AssertionError(f"cb grammar: answer {raw!r} does "
                                         "not parse as a joint triad")
            print(f"[{card}] cb (b) grammar: 8 of 8 answers parse as joint "
                  "triads")
            for label, ref in (("a", "unconstrained"), ("b", "grammar")):
                same = sum(x["answer"] == y["answer"] for x, y in
                           zip(runs[label][0], lockstep[ref][1]))
                print(f"[{card}] cb ({label}) against phase 8's {ref} "
                      f"run_eval on the same 8 items: wall "
                      f"{runs[label][2]:.1f} ms against "
                      f"{lockstep[ref][0]:.1f} ms; {same} of 8 answers "
                      "equal")

            # (f) an online session of image 0's four requests, two of them
            # submitted three rounds late, against generate on one pool
            items = [ds[i] for i in range(4)]
            prompts = [it["prompt"] for it in items]
            _TimedBatcher.spd = 1
            _TimedBatcher.log = []
            reset_launches()
            cb = _TimedBatcher(model._decoder_params(), args, tok, slots=4,
                               ens5_params=model.params, ens5_cfg=model.cfg,
                               vocab_limit=model.true_vocab,
                               device=model.device)
            prefix = cb.make_prefix(image=items[0]["image"])
            texts = cb.generate(prompts, max_gen_len=32,
                                prefixes=[prefix] * 4,
                                additional_stop_symbols=[sep])
            want = _TimedBatcher.log[-1][1]
            sess = cb.online(additional_stop_symbols=[sep])
            rids = [sess.submit(p, max_gen_len=32, prefix=prefix)
                    for p in prompts[:2]]
            for _ in range(3):
                sess.step()
            rids += [sess.submit(p, max_gen_len=32, prefix=prefix)
                     for p in prompts[2:]]
            sess.drain()
            got = [sess.poll(r) for r in rids]
            launches = {n: KERNELS[n][2].launches for n in KERNELS}
            for n, c in launches.items():
                totals[n] += c
            require_counts(launches, CB_KERNELS + ("decode_attention",),
                           "cb (f)")
            if [g["tokens"] for g in got] != want or [
                    g["text"] for g in got] != texts:
                raise AssertionError("cb (f): the online session's ids "
                                     "differ from generate's")
            st = sess.stats()
            print(f"[{card}] cb (f) online session, 2 + 2 staggered "
                  f"submits: ids equal generate's; TTFT from submit p50 "
                  f"{st['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
                  f"{st['tpot_p50_ms']:.2f} ms")

            # where an admission's time goes: one group of the four
            # questions against the prefix, by kernel (after the counts)
            @torch.inference_mode()
            def admit():
                cb._admit_many([
                    (s, s, tok.encode(p, bos=True, eos=False), None, prefix)
                    for s, p in enumerate(prompts)])
                cb._active = [None] * 4

            admit()
            _, wall = cb._timed(admit)
            times = kernel_times(admit, 1)
            print_profile(card, f"cb one admission of 4 questions against "
                          f"the prefix (wall {wall:.1f} ms)", times, {
                              "int4 tile (K1)": ("int4_mma_kernel",),
                              "GEMV": GEMV_KERNELS,
                              "flash attention (K2)": ("flash_fwd",),
                              "copies and fills": ("copy", "ndex", "Fill")})
            del cb, prefix, sess
    finally:
        serving_batch.ContinuousBatcher = real
        model.kv_cache_bits = None
    print(f"[{card}] cb: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the ragged step with every row at one position is decode_step, bit
    # for bit (kernel path, full width)
    device = model.device
    gen = torch.Generator(device=device).manual_seed(9)
    params = model.params["llama"]
    with torch.inference_mode():
        toks = torch.randint(3, model.true_vocab, (4, 40), generator=gen,
                             device=device)
        cache = llama.KVCache.create(args, 4, 48,
                                     dtype=params["norm"]["weight"].dtype,
                                     device=device)
        logits, cache, _ = llama.prefill(params, args, cache, toks)
        nxt = logits.argmax(-1, keepdim=True)
        other = clone_cache(cache)
        want, cache = llama.decode_step(params, args, cache, nxt, 40)
        got, other = llama.decode_step_ragged(
            params, args, other, nxt,
            torch.full((4,), 40, dtype=torch.int32, device=device))
    if not torch.equal(got, want) or not all(
            torch.equal(a, b) for a, b in zip((*cache.k, *cache.v),
                                              (*other.k, *other.v))):
        raise AssertionError("cb: decode_step_ragged at one position differs "
                             "from decode_step")
    print(f"[{card}] cb: decode_step_ragged with every row at one position "
          "equals decode_step bit for bit (logits and cache)")
    del cache, other
    gc.collect()
    torch.cuda.empty_cache()
    return totals


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
    requests of all modes: the per-request deltas of ``run``, so neither
    the step profile, the ids replay nor the step checks are counted."""
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

    totals = {n: 0 for n in KERNELS}

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
        for n, c in delta.items():
            totals[n] += c
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
              f"launches {delta}; ids digest {ids_digest(out)}")
        if not out or any(not (0 <= t < 32000) for t in out):
            raise AssertionError(f"{label}: malformed ids {out}")
        # lookup and grammar runs are not the vanilla loop: no replay
        vanilla = not kw.get("draft_k") and kw.get("fsm") is None
        note_ids(card, f"latency {label}", [out],
                 (model, prompt, image) if vanilla else None)
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
    decode_profile(card, "latency (a), batch 1", model, prompt, image)
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
    launches = {n: totals[n] for n in LATENCY_KERNELS}
    require_counts(launches, LATENCY_KERNELS, "latency")

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
              f"launches {delta}; ids digest {ids_digest(outs)}")
        for out in outs:
            if not out or any(not (0 <= t < 32000) for t in out):
                raise AssertionError(f"{label}: malformed ids {out}")
        note_ids(self.card, f"quant {label}", outs,
                 None if kw.get("draft_k") else
                 (model, prompts or self.prompt,
                  self.image if images is None else images))
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


def quantizer(count) -> dict:
    """The row quantizer's expected launches for ``_QuantRequest.run``
    (none asked of a parent tree without the kernel)."""
    return {"quantize_act_int8": count} if QUANTIZER_KERNEL else {}


def run_quant_modes(card: str, model) -> dict:
    """Phase 7, modes (i)-(o), on phase 4's int4 model. Returns the launch
    counts summed over the modes' requests (the checks are not counted)."""
    from a3vlm_tpu_torch.models import ens5, llama

    req = _QuantRequest(card, model)
    L = model.args.n_layers
    reset_launches()
    # the exact int4 path: the ids and prefill logits the inexact modes are
    # printed against
    ref = req.run("(ref) exact int4", {
        "int4_matmul": lambda s: PER_FORWARD * (1 + s),
        "decode_attention": lambda s: L * s, **quantizer(0)})
    ref_prefill_ms = model.last_stats["prefill_ms"]
    exact_logits = req.forwards("(ref) exact int4")
    prefill_profile(card, "quant (ref) exact int4", model, req.prompt,
                    req.image)

    def against_exact(label, logits, ids):
        print(f"[{card}] quant {label}: prefill logits rel err against the "
              f"exact int4 path {rel_err(logits, exact_logits):.3e}")
        req.report_ids(label, ids, ref, "the exact int4 run's")

    # (i) W4A8 decode: every M <= 32 matmul, the prefill's head (one row)
    # among them, through the W4A8 kernel, each after the row quantizer;
    # the prefill's linears stay
    qmm.W4A8_DECODE = True
    try:
        ids = req.run("(i) W4A8 decode", {
            "int4_matmul_w4a8": lambda s: 1 + PER_FORWARD * s,
            "int4_matmul": PER_FORWARD - 1, "int4_matmul_w8a8p": 0,
            **quantizer(lambda s: 1 + PER_FORWARD * s)})
        decode_profile(card, "quant (i) W4A8 decode, batch 1", model,
                       req.prompt, req.image)
        against_exact("(i)", req.forwards("(i) W4A8"), ids)
        # (k) both A8 modes and lookup: the whole prompt prefilled through
        # the W8A8 kernel, rounds of 8 rows through the W4A8 kernel and K5
        qmm.W8A8_PREFILL = True
        ids = req.run("(k) W4A8 + W8A8P + draft_k=8", {
            "int4_matmul_w8a8p": PER_FORWARD - 1,
            "int4_matmul_w4a8": lambda s: 1 + PER_FORWARD * s,
            "verify_attention": lambda s: L * s,
            "int4_matmul": 0,
            **quantizer(lambda s: PER_FORWARD * (1 + s))}, draft_k=8)
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
            "int4_matmul_w4a8": 0, **quantizer(PER_FORWARD - 1)})
        print(f"[{card}] quant (j): prefill "
              f"{model.last_stats['prefill_ms']:.1f} ms in the W8A8 mode "
              f"against {ref_prefill_ms:.1f} ms on the exact route ((ref))")
        prefill_profile(card, "quant (j) W8A8 prefill", model, req.prompt,
                        req.image)
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
    # (o) the dense prefill route: the prefill's 280 linears (1487 rows)
    # dequantize their weight and take two dense products; the head (one
    # row) and every decode step stay on the GEMV. Its prefill time is the
    # yardstick of the kernel route's.
    qmm.PREFILL_DENSE_MIN_M = 256
    try:
        ids = req.run("(o) PREFILL_DENSE_MIN_M=256", {
            "int4_matmul": lambda s: 1 + PER_FORWARD * s})
        print(f"[{card}] quant (o): prefill "
              f"{model.last_stats['prefill_ms']:.1f} ms on the dense route "
              f"against {ref_prefill_ms:.1f} ms on the kernel route ((ref))")
        against_exact("(o)", req.forwards("(o) dense prefill"), ids)
    finally:
        qmm.PREFILL_DENSE_MIN_M = None
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
    towers_profile(card, "quant (n0) dense towers, batch 4", model, images)
    try:
        for k in dense_towers:
            model.params[k] = tree_map(lambda t: t, dense_towers[k])
        model.quantize(bits=None, tower_bits=8)
        n_q = []
        tree_map(lambda t: n_q.append(isinstance(t, QuantizedWeight)),
                 {k: model.params[k] for k in dense_towers})
        if sum(n_q) < 4 * 3 + 2:
            raise AssertionError(f"(n): only {sum(n_q)} tower leaves are int8")
        before = quantize_act_int8.launches
        ids = req.run("(n) tower_bits=8, batch 4", {
            "int4_matmul": lambda s: PER_FORWARD * (1 + s)},
            images=images, prompts=prompts)
        n_quant = quantize_act_int8.launches - before
        print(f"[{card}] quant (n): row quantizer launched {n_quant} times "
              f"in the request")
        if QUANTIZER_KERNEL and not n_quant:
            raise AssertionError("(n): the towers never launched the row "
                                 "quantizer")
        towers_profile(card, "quant (n) tower_bits=8, batch 4", model,
                       images)
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
        "decode_attention": lambda s: L * s, "int4_matmul": 0,
        **quantizer(0)})
    decode_profile(card, "quant (h) int8 decoder, batch 1", model,
                   req.prompt, req.image)
    req.forwards("(h) int8")
    return req.totals


def run_training(card: str, model):
    """Phase 5 on phase 4's model; returns the training kernels' launch
    counts from the 4 train steps and what phase 10 goes on from: the
    trained state, the step function, the trainable mask and the
    batch."""
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
    return launches, {"state": state, "step": step, "mask": mask,
                      "batch": batch}


# Phase 10 (d): the prefill logits of the dense 2-layer model with the
# adapters merged (W + A @ B rounded once to bf16) against the same model
# with them unmerged (x @ W + (x @ A) @ B): the bound of the kernel-vs-plain
# prefill, as both paths round to bf16 at as many places.
MERGE_REL_TOL = LOGITS_REL_TOL
CKPT_SERVE_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                      "vit_attention")


def launch_counts() -> dict:
    return {n: KERNELS[n][2].launches for n in KERNELS}


def launches_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in launch_counts().items()}


def state_leaves(state, mask) -> list:
    """The trainable parameters and both moments of a ``TrainState``."""
    from a3vlm_tpu_torch.train.step import partition_params, tree_leaves

    return (tree_leaves(partition_params(state.params, mask)[0])
            + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu))


def max_diff(a: list, b: list) -> float:
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} leaves against {len(b)}")
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def run_ckpt_loop(card: str, model, trained: dict, root) -> None:
    """Phase 10 (a) and (b) on phase 5's model and trained state."""
    from a3vlm_tpu_torch.checkpoint.manager import (
        CheckpointManager,
        find_latest_checkpoint,
    )
    from a3vlm_tpu_torch.quant import tree_map
    from a3vlm_tpu_torch.train.step import TrainState

    state, step, mask, batch = (trained[k] for k in
                                ("state", "step", "mask", "batch"))

    def two_steps(st):
        losses = []
        for _ in range(2):
            st, metrics = step(st, batch)
            losses.append(float(metrics["loss"]))
        return st, losses

    # (a) an asynchronous save, two steps while it is written, a restore
    # into a fresh TrainState and the same two steps from there
    out = root / "loop"
    mgr = CheckpointManager(str(out))
    saved = [t.clone() for t in state_leaves(state, mask)]
    count = state.opt_state.count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    path = mgr.save(0, 4, params=state.params, opt_state=state.opt_state,
                    step=state.step, trainable_mask=mask, wait=False)
    blocking_ms = (time.perf_counter() - t0) * 1e3
    state, losses_u = two_steps(state)
    torch.cuda.synchronize()
    mgr.wait_until_finished()
    write_s = mgr.last_write_seconds
    if not (Path(path) / "_DONE").exists() or \
            find_latest_checkpoint(str(out)) != path:
        raise AssertionError(f"async save: {path} not finalized or not "
                             "found as the latest")
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())

    def restore():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = mgr.restore_params(path, state.params)
        extra = mgr.restore_train_state(path, state.opt_state)
        restored = TrainState(params, extra["opt_state"], extra["step"])
        torch.cuda.synchronize()
        return restored, time.perf_counter() - t0

    restored, restore_s = restore()
    got = state_leaves(restored, mask)
    if restored.step != 4 or restored.opt_state.count != count or any(
            a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b)
            for a, b in zip(got, saved)) or len(got) != len(saved):
        raise AssertionError("restore: a leaf, the step or the count "
                             "differs from what was saved")
    print(f"[{card}] ckpt (a): {len(saved)} leaves (trainables and both "
          f"moments, {nbytes / 2**30:.3f} GiB on disk); save blocking "
          f"{blocking_ms:.1f} ms (the host copy), write {write_s:.2f} s in "
          f"the background beside 2 train steps, restore {restore_s:.2f} s; "
          f"every restored leaf equal to the saved one, step "
          f"{restored.step}, count {restored.opt_state.count}")
    del saved, got
    resumed, losses_r = two_steps(restored)
    # the training kernels' spread: the same two steps again from a second
    # restore of the same checkpoint
    again, losses_a = two_steps(restore()[0])
    spread = max_diff(state_leaves(resumed, mask), state_leaves(again, mask))
    loss_spread = max(abs(a - b) for a, b in zip(losses_r, losses_a))
    diff = max_diff(state_leaves(resumed, mask), state_leaves(state, mask))
    loss_diff = max(abs(a - b) for a, b in zip(losses_r, losses_u))
    print(f"[{card}] ckpt (a): losses uninterrupted {losses_u}, resumed "
          f"{losses_r}, resumed again {losses_a}; max |diff| resumed vs "
          f"uninterrupted: leaves {diff:.3e}, losses {loss_diff:.3e}; the "
          f"same two steps twice from one state (the kernels' spread): "
          f"leaves {spread:.3e}, losses {loss_spread:.3e}")
    print(f"[{card}] ckpt (a) max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if diff > spread or loss_diff > loss_spread:
        raise AssertionError("a resumed run left the kernels' spread")
    del resumed, again, restored

    # (b) the final state as a checkpoint, served on the int4 model in the
    # serving dtypes, against the in-memory adapters
    final = mgr.save(0, params=state.params, opt_state=state.opt_state,
                     step=state.step, trainable_mask=mask)
    model.params = tree_map(
        lambda p: p.to(torch.bfloat16)
        if not isinstance(p, QuantizedWeight) and p.dtype == torch.float32
        else p, {k: v for k, v in state.params.items() if k != "lora"})
    model.quantize(bits=None)  # drops attached adapters
    prompts, images = serving_inputs()
    model.load_lora(state.params["lora"])
    want = model.generate_tokens(prompts, images=images, max_gen_len=32,
                                 temperature=0.0)
    model.quantize(bits=None)
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    t0 = time.perf_counter()
    model.load_adapter_checkpoint(final)
    load_s = time.perf_counter() - t0
    before = launch_counts()
    got = model.generate_tokens(prompts, images=images, max_gen_len=32,
                                temperature=0.0)
    torch.cuda.synchronize()
    launches = launches_since(before)
    require_counts(launches, CKPT_SERVE_KERNELS, "adapter serving")
    require_no_fallback(card, "adapter serving")
    print(f"[{card}] ckpt (b): load_adapter_checkpoint {load_s:.2f} s; "
          f"ids digest {ids_digest(got)} (in-memory adapters "
          f"{ids_digest(want)}); launches "
          f"{ {n: launches[n] for n in CKPT_SERVE_KERNELS} }")
    if got != want:
        raise AssertionError("serving the checkpoint gave other ids than "
                             "serving the in-memory adapters")


def hold_records(results: str, task: str, label: str) -> int:
    """The eval CLI's records: one a task item, in order, in the schema."""
    from a3vlm_tpu_torch.eval_affordance import VQADataset, _question_of

    ds = VQADataset(task, input_size=448)
    with open(results) as f:
        records = json.load(f)
    keys = {"answer", "format_answer", "annotation", "question", "image",
            "fail"}
    if [(r["image"], r["question"]) for r in records] != [
            (d["image"], _question_of(d)) for d in ds.data] or any(
                set(r) != keys for r in records):
        raise AssertionError(f"{label}: records out of order or schema")
    return len(records)


def run_finetune_cli(card: str, root) -> None:
    """Phase 10 (c) and (d): the training CLI at full width on a 2-layer
    checkpoint, resumed, uncached; the eval CLI serving its adapter; the
    merge."""
    import shutil

    from a3vlm_tpu_torch import eval_affordance, main_finetune
    from a3vlm_tpu_torch.checkpoint.manager import find_latest_checkpoint
    from a3vlm_tpu_torch.meta import MetaModel

    task = write_eval_tasks(root, card)
    with open(task) as f:
        images = sorted({d["image"] for d in json.load(f)})
    (root / "dialog.json").write_text(json.dumps([
        {"image": images[i % 2], "conversations": [
            {"from": "human", "value": EVAL_QUESTIONS[i % 4]},
            {"from": "gpt", "value": "<rb>revolute</rb>"
             "[0.50,0.50,0.30,0.20,0.00]"}]} for i in range(8)]))
    (root / "data.yaml").write_text(
        f"META:\n - path: {root / 'dialog.json'}\n   type: image_text\n")
    ckpt, sd = write_decoder_checkpoint(root)
    del sd
    out = root / "ft"
    # a constant learning rate (min_lr = lr, no warmup), so a 1-epoch run
    # takes epoch 0's steps as a 2-epoch run does
    argv = ["--tokenizer_path", str(ckpt), "--data_config",
            str(root / "data.yaml"), "--dialog", "--pretrained_path",
            str(ckpt), "--quant", "--lora_rank", "16",
            "--only_save_trainable", "--checkpointing", "--batch_size", "2",
            "--lr", "1e-4", "--min_lr", "1e-4", "--warmup_epochs", "0",
            "--print_freq", "1", "--device", "cuda"]
    cached = ["--epochs", "2", "--save_iteration_interval", "2",
              "--cache_tower_features", "--feature_cache_dir",
              str(root / "features"), "--output_dir", str(out)]

    def run(extra):
        if hasattr(qmm, "reset_fallbacks"):
            qmm.reset_fallbacks()
        before = launch_counts()
        t0 = time.perf_counter()
        state = main_finetune.main(argv + extra, tokenizer=_PieceTable(32000))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        require_no_fallback(card, "training CLI")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return launches_since(before), secs

    def log(path):
        return [json.loads(line) for line in
                (path / "log.txt").read_text().splitlines()]

    # (c) two epochs, tower features cached in epoch 0 and spilled to disk
    first, secs = run(cached)
    names = ["epoch_0-iter_2", "epoch_0", "epoch_1-iter_2", "epoch_1"]
    found = sorted(d.name for d in out.iterdir() if d.name.startswith("ep"))
    if found != sorted(names) or not all((out / n / "_DONE").exists()
                                         for n in names):
        raise AssertionError(f"training CLI wrote {found}, want {names} "
                             "each with _DONE")
    require_counts(first, TRAIN_KERNELS, "training CLI")
    log_first = log(out)
    print(f"[{card}] ckpt (c) CLI, 2 epochs x 4 steps, cached towers: "
          f"{secs:.1f} s with the load; wrote {names}; log {log_first}; "
          f"launches { {n: first[n] for n in TRAIN_KERNELS} }")
    # the same without the epoch-1 checkpoints: --resume auto goes on from
    # epoch_0 and must give epoch 1 as before, the towers replayed from
    # the disk cache
    kept = root / "ft_epoch_1"
    kept.mkdir()
    for n in names[2:]:
        shutil.move(str(out / n), str(kept / n))
    if find_latest_checkpoint(str(out)) != str(out / "epoch_0"):
        raise AssertionError("the latest checkpoint is not epoch_0")
    resumed, secs = run(cached + ["--resume", "auto"])
    log_resumed = log(out)
    if len(log_resumed) != 3 or log_resumed[2]["epoch"] != 1:
        raise AssertionError(f"resume ran other epochs: {log_resumed}")
    same = log_resumed[2] == log_first[1]
    stored = [torch.load(d / "epoch_1" / "model.pt", weights_only=True)
              for d in (kept, out)]
    print(f"[{card}] ckpt (c) --resume auto from epoch_0: {secs:.1f} s; "
          f"epoch 1 log {log_resumed[2]} (first run {log_first[1]}, "
          f"equal {same}); vit_attention launches {resumed['vit_attention']}"
          f" (towers replayed from disk)")
    if not same or resumed["vit_attention"]:
        raise AssertionError("the resumed epoch differs, or ran the towers")
    if _tree_tensors(stored[0]) != _tree_tensors(stored[1]):
        raise AssertionError("the resumed run's epoch_1 differs")
    # one epoch without the cache: epoch 0 as with it, the towers as often
    uncached, secs = run(["--epochs", "1", "--output_dir",
                          str(root / "ft_uncached")])
    log_uncached = log(root / "ft_uncached")
    print(f"[{card}] ckpt (c) 1 epoch uncached: {secs:.1f} s; log "
          f"{log_uncached[0]}; vit_attention launches "
          f"{uncached['vit_attention']} (cached run "
          f"{first['vit_attention']})")
    if log_uncached[0] != log_first[0] or \
            uncached["vit_attention"] != first["vit_attention"]:
        raise AssertionError("the cached epoch 0 differs from the uncached")

    # the eval CLI serving the adapter checkpoint on the int4 base
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    before = launch_counts()
    t0 = time.perf_counter()
    results = eval_affordance.main(
        ["--pretrained_path", str(ckpt), "--dataset", task, "--output_dir",
         str(root / "eval"), "--batch_size", "4", "--max_gen_len", "8",
         "--temperature", "0", "--quant", "--adapter_path",
         str(kept / "epoch_1"), "--device", "cuda"],
        tokenizer=_PieceTable(32000))
    secs = time.perf_counter() - t0
    launches = launches_since(before)
    require_counts(launches, CKPT_SERVE_KERNELS, "eval CLI --adapter_path")
    require_no_fallback(card, "eval CLI --adapter_path")
    n = hold_records(results, task, "eval CLI --adapter_path")
    print(f"[{card}] ckpt (c) eval CLI --adapter_path epoch_1 --quant: {n} "
          f"records in order, {secs:.1f} s with the load; launches "
          f"{ {k: launches[k] for k in CKPT_SERVE_KERNELS} }")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the dense model, the adapters unmerged and merged
    model = MetaModel.from_pretrained(str(ckpt), with_visual=True,
                                      device="cuda",
                                      tokenizer=_PieceTable(32000))
    prompts, images = serving_inputs()
    with torch.inference_mode():
        base = model.compute_logits(prompts, images=images)
        model.load_adapter_checkpoint(str(kept / "epoch_1"))
        unmerged = model.compute_logits(prompts, images=images)
        model.quantize(bits=None)  # drops the unmerged adapters
        model.load_adapter_checkpoint(str(kept / "epoch_1"), merge=True)
        merged = model.compute_logits(prompts, images=images)
    cat = [torch.cat([torch.from_numpy(x).flatten() for x in lg])
           for lg in (base, unmerged, merged)]
    rel = float((cat[2] - cat[1]).norm() / cat[1].norm())
    effect = float((cat[1] - cat[0]).norm() / cat[1].norm())
    print(f"[{card}] ckpt (d) merge_lora at full width (2 layers, bf16): "
          f"prefill logits merged vs unmerged rel err {rel:.3e} (limit "
          f"{MERGE_REL_TOL}); the adapters move the logits by {effect:.3e} "
          f"(rel, unmerged vs none)")
    if not all(torch.isfinite(c).all() for c in cat) or rel > MERGE_REL_TOL:
        raise AssertionError(f"merged logits rel err {rel:.3e}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def _tree_tensors(tree) -> list:
    """Every tensor of a stored tree as (path, bytes), for equality."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif x is not None:
            out.append((path, str(x.dtype), tuple(x.shape),
                        x.reshape(-1).view(torch.uint8).numpy().tobytes()))

    walk(tree, "")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3 (no result lines)")
    parser.add_argument("--ids-out", metavar="PATH",
                        help="write every run's generated ids as JSON")
    parser.add_argument("--ids-ref", metavar="PATH",
                        help="ids of another run (--ids-out) to hold this "
                             "run's against, label by label")
    opts = parser.parse_args(argv)
    if opts.ids_ref:
        with open(opts.ids_ref) as f:
            IDS_REF.update(json.load(f))
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
    for line in check_build_log(path, TENSOR_CORE_KERNELS
                                + CLUSTER_PTXAS_KERNELS):
        print(f"[{card}] ptxas {line}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    with torch.inference_mode():
        check_int4(gen, results)
        check_int8(gen, results)
        check_int4_variants(gen, results)
        check_quantizer(results)
        check_glu(gen, results)
        check_flash(gen, results)
        check_flash_extension(gen, results)
        check_flash_bwd(gen, results)
        check_decode(gen, results)
        check_latency_kernels(gen, results)
        check_vit(gen, results)
    for r in results:
        # the tensor-core kernels also get their achieved rate
        # (the row's own operation or byte count over the kernel's time)
        # and the share of the bound they reach
        rate = ""
        tiled = (r["name"] in TILED_MATMULS
                 and int(r["case"].split()[0][2:]) > qmm.GEMV_MAX_M)
        if r["name"] in TENSOR_CORE_ATTENTION or tiled:
            rate = (f" {r['bytes'] / r['ms'] / 1e6:.1f} GB/s"
                    if r["bound_by"] == "bytes"
                    else f" {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s")
            rate += f" ({r['bound_ms'] / r['ms']:.0%} of bound)"
        lib = r["library_ms"]

        def vs_lib(t):
            return f"{t / lib:.2f}x library" if lib else "no library call"

        if "device_ms" in r:  # timed cold (``time_cold``)
            dev = r["device_ms"]
            rate = (f" device {dev:.4f} ms ({r['bound_ms'] / dev:.0%} of "
                    f"bound, {vs_lib(dev)}; "
                    f"{r['launches_per_call']:g} launches a call)"
                    if dev else " device not measured")
            rate += (f" host {r['host_ms']:.4f} ms a call; kernel "
                     f"{vs_lib(r['ms'])}; cold L2 over {r['copies']} copies")
            if r.get("kernel_device_ms"):
                k = r["kernel_device_ms"]
                rate += (f"; the kernel alone {k:.4f} ms on the device "
                         f"({r['bound_ms'] / k:.0%} of bound, {vs_lib(k)})")
        print(f"[{card}] {r['name']:25s} {r['case']:46s} max_abs_err "
              f"{r['err']:.3e} kernel {r['ms']:.4f} ms{rate} plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) library "
              + (f"{lib:.4f} ms" if lib else "none"))
    if FAILURES:
        raise AssertionError("kernel checks failed:\n" + "\n".join(FAILURES))
    if opts.kernels_only:
        return 0

    # 4. serving path, 8. the eval path, 9. continuous batching, 6.
    # latency path and 7. the quantized modes over the int4 decoder (on
    # phase 4's weights, which phase 5 recasts), 5. training path, then 7.
    # mode (h) on an int8 model of its own
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    model, serve = run_main_path(card)
    require_no_fallback(card, "serving")
    evals, lockstep = run_eval_path(card, model)
    print(f"[{card}] launches in the eval path: "
          f"{ {n: evals[n] for n in EVAL_KERNELS} }")
    cb = run_cb_path(card, model, lockstep)
    require_no_fallback(card, "continuous batching")
    latency = run_latency_path(card, model)
    require_no_fallback(card, "latency")
    quant = run_quant_modes(card, model)
    require_no_fallback(card, "quantized modes (i)-(o)")
    train, trained = run_training(card, model)
    require_no_fallback(card, "training")
    # 10. the fine-tuning loop: checkpoint, resume and serve phase 5's
    # state, then the training and eval CLIs and the merge on a 2-layer
    # checkpoint of their own
    reset_launches()
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_ckpt_loop(card, model, trained, Path(tmp))
        del model, trained
        gc.collect()
        torch.cuda.empty_cache()
        t_cli = time.perf_counter()
        run_finetune_cli(card, Path(tmp))
    ckpt = launch_counts()
    print(f"[{card}] phase 10: {time.perf_counter() - t10:.1f} s, of which "
          f"(c)-(d), the CLIs and the merge, {time.perf_counter() - t_cli:.1f}"
          " s")
    for name, count in run_int8_mode(card).items():
        quant[name] += count
    require_no_fallback(card, "quantized mode (h)")
    require_counts(quant, QUANT_KERNELS, "quantized-mode")

    table = []
    for name, (source, replaces, _) in KERNELS.items():
        mine = [r for r in results if r["name"] == name]
        by_path = {"serve": serve.get(name, 0),
                   "cb": cb.get(name, 0),
                   "latency": latency.get(name, 0),
                   "train": train.get(name, 0),
                   "quant": quant.get(name, 0),
                   "ckpt": ckpt.get(name, 0)}
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
    if opts.ids_out:
        with open(opts.ids_out, "w") as f:
            json.dump(IDS, f)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
