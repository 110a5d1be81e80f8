"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the hand-written kernels (a3vlm_tpu_torch/csrc) with
   nvcc and prints the build time and what ptxas reported of the
   tensor-core kernels (K2, K9a, K9b, K10, the tiled quantized matmuls of
   K1, K1v3, K11 and K6, K11's pre-pass, and the verify kernel of K5 and
   K5q, and K8's W8A8 tile: registers, spills), of the cluster kernels
   (the decode kernel of K3, K3u, K4 and K4 fused, at head dims 128 and
   64, and the GEMV of K1, K1v3, K11, K7 and K6) and of the row
   quantizer; they must not spill and
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
   own. Then phase 11's shapes (``check_families``, a generator of their
   own): K1's GEMV at 4096x1024 and the 4096x92544 head, its tile at M
   1341; K2 at H32/Hkv8 over 1341 keys (batch 1 and 4) and H40 over 2956;
   K3, K4 fused, K5 and K5q at G 4; K10 at 10 crops. Last, phase 12's
   (``check_falcon``): K1's GEMV (M 1, 4) and tile (M 1024, and 128 on
   wq) on Falcon-180B's four linears and its 65024-wide head; K2 at head
   dim 64 with 232 query heads over 8 kv heads (the batch-4 prefill of 32
   ids and the loss's 2 x 512), K9a/K9b at head dim 64 and at InternLM2's
   G 4 over 1551 keys; the decode kernel's head-dim-64 instance at G 29
   (K3, K3u, K4, K4 fused) at batch 1 and 4 over 80 rows and at batch 4
   over 2048.
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

11. the other families at full width (after phase 10 and mode (h); it
   frees its models): (a) ``internlm_ems5_light`` as released
   (``InternlmEns5Config()``: InternLM2-7B, 32 query heads over 8 kv
   heads, ffn 14336, vocab 92544 from a synthetic 92544-piece table, rope
   theta 1e6; DINOv2 at 224 crops and ConvNeXt-XXL at 512 crops of
   1024 px images; 1295 image words) with int4 decoder weights from a seed,
   quantized in place leaf by leaf: 4 requests (a 1024 px image and 41-47
   ids each) through ``generate_tokens`` at batch 4 and, for one of them,
   at batch 1 vanilla, write-then-attend (ids equal), with the int8 cache
   and with ``draft_k = 8`` over both caches (ids equal the vanilla run's,
   or differ first where the kernel path's top-2 logit gap is within its
   kernel-vs-plain error); K1, K2, K3, K3u, K4 fused, K5, K5q and K10
   launched, no fallback route; one decode step's device time at batch 4
   and 1; prefill logits against the plain path. Then the CLI,
   ``eval_affordance.main --llama_type internlm_ems5_light --input_size
   1024 --quant --score``, on a 2-layer full-width InternLM2 checkpoint
   over 2 PNG images of 1024 px x 4 questions at batch 4, records in order
   and in the schema. (b) ``llama_ens5_2images``: phase 4's 13B weights
   rebuilt from the seed (the decoder's digest equal to phase 4's) with two
   depth tags more; 2 requests (an RGB and a depth image of 448 px, 43 and
   47 ids) at batch 2 and 1 (2910 image words, K2 over 2942 keys, K10 at
   10 crops a stream); prefill logits against the plain path;
   ``generate_tokens`` without depth images refuses. (c) ``llama``: the
   same packed decoder as a text-only model, 4 prompts, whose ids must
   equal those of a ``llama_ens5`` model over the same tree given no
   images.

12. falcon, the families' training and the depth cache (after phase 11;
   it frees its models): (a) ``falcon`` at ``FalconArgs()`` widths
   (Falcon-180B: hidden 14848, 232 heads over 8 kv heads, head dim 64, MLP
   59392, rope theta 1e4; vocab 65024 from a synthetic table) cut to 16 of
   its 80 layers, int4 linears and head made layer by layer from a seed:
   4 prompts (41-47 ids) at batch 4 and one at batch 1, 32 new ids,
   greedy, vanilla and with the int8 cache (its ids held against the
   vanilla run's by phase 11's gap rule); K1, K2 and the decode kernel's
   head-dim-64 instance launched (K3 fused, or K4 fused), no fallback;
   one decode step's device time by kernel; prefill logits against the
   plain path; one loss and backward through ``MetaModel.forward`` on 2 x
   512 ids (K9a/K9b at head dim 64). (b) three QLoRA steps (rank 16, int4
   base, bf16 over float32 masters, AdamW clip 8) on one repeated batch,
   each loss and grad norm finite and the loss falling:
   ``internlm_ems5_light`` as released (2 images of 1024 px and 256 ids;
   ``MetaModel.forward``'s loss, as the JAX CLI does not train it), then
   phase 4's 13B weights as ``llama_ens5_2images`` (an RGB and a depth
   image, 128 ids) and its decoder as ``llama`` (2 x 2048 ids) through the
   CLI's loss and step. (c) the CLI's pieces for ``llama_ens5_2images
   --cache_tower_features`` on phase 10's 2-layer checkpoint over a dialog
   dataset with a depth stream: two epochs cached (no K10 launch in the
   second) give the uncached run's losses exactly.

13. ModelServer, datagen and the closed-loop gates: (a) right after phase
   4, ``ModelServer(meta_model=<phase 4's model>)`` serves phase 4's
   requests through ``generate`` (their ids as text, ``_TokenText``), the
   ids equal to phase 4's, and one ``stream_generate``, ``compute_logits``
   and ``evaluate_examples`` equal the ``MetaModel`` calls; after phase 12,
   ``ModelServer(pretrained_path=<phase 8's 2-layer checkpoint>,
   quant=True, kv_cache_bits=8)`` runs phase 8's task file through
   ``run_eval`` (K1, K2, K4 fused and K10, no fallback). (b) datagen at
   the reference's defaults (960 px, 5 poses x 8 joint values, 32768
   points a frame) with each stage's seconds; the native rasterizer must
   have built. (c) the accuracy gate of ``scripts/torch_end_task_gate.py``:
   the 192 px corpus, a small ``llama_ens5`` (``card_config``) trained to
   memorization in bf16 over float32 masters, scored through
   ``ModelServer.generate`` against the JAX gate's thresholds; (d) the A8
   gate on the same model (dense, int4, W4A8 decode, W8A8 prefill), no
   delta against int4 below -0.05. The gate path must launch K1 (GEMV and
   tile), K2 with and without lse, K9a, K9b, K10, K3 fused, K7 and K8, no
   fallback.

14. several ranks (``a3vlm_tpu_torch/parallel``), two on this one card
   (``devices=["cuda:0", "cuda:0"]``: the gloo backend, collectives
   through host memory): (a) right after phase 13 (a),
   ``ModelServer(meta_model=<phase 4's model>, model_parallel_size=2)``
   (the all-column int4 tree) on phase 4's requests, 8 new ids, its ids
   phase 4's or a near tie by the gap rule of phases 9 and 11; (c) right
   after phase 9, ``ContinuousBatcher(mesh=)`` at mp 2 through
   ``run_eval_continuous`` on every rank over phase 9's task file, 8 new
   ids, held against phase 9 (a); (b)
   after phase 13, phase 8's 2-layer checkpoint through
   ``ModelServer(pretrained_path=..., quant=True, model_parallel_size=2)``
   (the row-parallel tree: wo and w2 chunk-packed, a chunk a rank, K1's
   tile at group 32), held against the same tree on one rank. Each prints
   every rank's backend, launches by kernel, fallbacks (0 required) and
   ids (every rank's equal to rank 0's).

15. training on several ranks, after phase 14 (b): the training CLI
   (``main_finetune.train``) on phase 8's 2-layer full-width checkpoint
   (towers from the seed; its linears divided by the square root of their
   input width, so the loss is ~10 and not ~300, where bf16 rounding alone
   moves it by ~1%), QLoRA rank 16, accumulation 2, remat, 3 updates
   of a global batch of 2 over 12 dialog items of phase 8's images: on one
   rank, then on two ranks of this card (``--devices cuda:0,cuda:0``,
   gloo) at (a) data 2 x model 1 and (b) data 1 x model 2 (the all-column
   int4 tree, ``tp_align`` 256). Each mesh run's first loss is one rank's
   within a relative 2e-3, its later losses and grad norms within 2e-2;
   every rank launches K1, K2, K9a, K9b and K10 with no fallback, and its
   replicated trainables are the same bytes as rank 0's (the CLI checks
   each update; each rank's digest printed). Each run prints every
   update's ms, rank 0's host time in the collectives (the
   ``collective:*`` spans of ``parallel/mesh.py`` in a ``torch.profiler``
   trace) and each rank's peak memory. (c) (b)'s checkpoint resumed on one
   rank (``--resume``): every restored trainable and moment equals the
   saved file's (``torch.equal``). Phase 3's ``check_mptrain`` rows hold
   K1's tile at a model-2 rank's training shapes (M 4096: 5120 x 2560,
   5120 x 6912, 13824 x 2560) and ``check_flash_bwd`` K2 with lse, K9a and
   K9b at its 20 heads.

``python3 chip_smoke.py --kernels-only`` stops after phase 3.
``--ids-out PATH`` writes every run's generated ids; ``--ids-ref PATH``
holds this run's ids against another run's (a parent commit's, say, with
this script run over its package) label by label, and where they differ
prints the first differing index with this run's top-2 logit gap there
and the kernel-vs-plain logit error of that step.

The line before the last is the kernel table as JSON (``launches`` sums
the serving, continuous-batching, latency, training, quantized-mode,
fine-tuning-loop, families, phase-12, gate, phase-14 and phase-15 runs
(rank 0's), ``launches_by_path`` splits them as ``serve``, ``cb``,
``latency``, ``train``, ``quant``, ``ckpt``, ``fam``, ``p12``, ``gate``,
``mp`` and ``mptrain``; ``bound_ms`` is the larger of the bytes
the call must move over 3.35 TB/s and its operations over 989 TFLOP/s, or
over 1979 TOP/s for the int8 tensor-core kernel; ``library_ms`` one
PyTorch library call on the same inputs, timed here and used nowhere in
the port); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
    calls; (None, 0) when the trace shows no such kernel. A trace that
    comes back with no device event at all is taken once more."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count, seen = 0.0, 0, False
        for e in prof.key_averages():
            # device events only (a CPU event may carry its kernels' time)
            if str(e.device_type).endswith("CUDA"):
                seen = True
                if kernel in e.key:
                    total += getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0.0))
                    count += e.count
        if seen:
            break
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


def int4_bytes(qw, M: int, *tensors, acts: int = 1) -> int:
    """Bytes a product with the int4 weight ``qw`` must move, at its true
    in_dim K: ``acts`` bf16 activations [M, K], the packed and the scale
    rows of K (not the zero rows the layout pads K to), and ``tensors``
    (the output, a residual) whole."""
    K, N = qw.in_dim, qw.q.shape[-1]
    return (acts * M * K * 2 + K // 2 * N * qw.q.element_size()
            + -(-K // qw.group) * N * qw.scale.element_size()
            + nbytes(*tensors))


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
                       int4_bytes(qw, m, got), 2 * m * K * N, library)
                if gemv:
                    time_cold(results[-1], lambda q, s: int4_matmul_2d(
                        x2, q, s, qw.group), copies)
                else:
                    results[-1]["ms"] = timed_ms(lambda: int4_matmul_2d(
                        x2, qw.q, qw.scale, qw.group), reps=3)
            del copies

# A rank's decoder linears of the 13B at model 2 in training (the
# all-column int4 tree, phase 15): (K, N) of wq/wk/wv/wo, w1/w3 and w2 (K
# 13824 padded to 14336), at the QLoRA step's M (2 x 2048).
MPTRAIN_LINEARS = ((5120, 2560), (5120, 6912), (13824, 2560))


def check_mptrain(results):
    """K1's tile at a model-2 rank's training shapes, on weights and x of
    a generator of their own."""
    g = torch.Generator(device="cuda").manual_seed(15)
    M = 4096
    for K, N in MPTRAIN_LINEARS:
        qw = _quantize_leaf_int4(random_weight(K, N, g))
        kpad = qw.q.shape[0] * 2
        x = randn(M, K, gen=g)
        x2 = F.pad(x, (0, kpad - K)).contiguous()
        got = int4_matmul(x, qw)
        err = compare(f"int4 mptrain M={M} K={K} N={N}", got,
                      int4_matmul(x, qw, impl="plain"))
        record(results, "int4_matmul",
               f"M={M} K={K}(pad {kpad}) N={N} mp2 train", err,
               timed_ms(lambda: int4_matmul_2d(x2, qw.q, qw.scale, qw.group),
                        reps=3),
               timed_ms(lambda: int4_matmul_2d_plain(x2, qw.q, qw.scale,
                                                     qw.group), reps=3),
               int4_bytes(qw, M, got), 2 * M * K * N,
               timed_ms(lambda: x @ _dequantize_leaf(qw, torch.bfloat16),
                        reps=3))


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
            flops = 2 * M * K * N

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
                   int4_bytes(qw, M, got), flops, library)
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
                       int4_bytes(qw, M, got), flops, library,
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
                       int4_bytes(qw, M, got), flops,
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
                   int4_bytes(qw, M, res, got, acts=2), 2 * M * K * N,
                   timed_ms(lambda: res + (F.silu(g[:, :K]) * u[:, :K])
                            @ _dequantize_leaf(qw, torch.bfloat16), reps))
            if M <= qmm.GEMV_MAX_M:
                time_cold(results[-1], lambda q, s: int4_matmul_2d_glu(
                    g, u, q, s, res, qw.group), copies)
        del copies


# (B, Hq, Hkv, Sq, Skv): the batch-4 prefill, GQA, a chunk of a chunked
# prefill, a short right-aligned chunk, and the single-request prefill
FLASH_SHAPES = ((4, 40, 40, 1487, 1487), (4, 40, 8, 1487, 1487),
                (4, 40, 40, 512, 1487), (1, 40, 40, 476, 1500),
                (1, 40, 40, 1487, 1487))


def check_flash(gen, results, shapes=FLASH_SHAPES, D=128):
    for B, Hq, Hkv, Sq, Skv in shapes:
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


def check_flash_samples():
    """The chunk shape on samples of their own (a generator per seed, as
    the card test and scripts/torch_flash_chunk_seeds.py draw them): with
    the softmax weights in bf16 alone, 12 of seeds 0-63 left the plain
    bound."""
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


TRAIN_FLASH_SHAPES = ((2, 40, 40, 2048, 2048), (2, 40, 8, 2048, 2048),
                      (2, 40, 40, 512, 2048), (1, 40, 40, 2048, 2048),
                      # a rank's heads of the 13B at model 2 (phase 15)
                      (2, 20, 20, 2048, 2048))


def check_flash_bwd(gen, results, shapes=TRAIN_FLASH_SHAPES, D=128):
    """K2 with its lse and K9a/K9b at the training shapes (B 2, S 2048),
    GQA, right-aligned, and one sample alone; both backward sides get the
    kernel's output and lse."""
    for B, Hq, Hkv, Sq, Skv in shapes:
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


# (B, Hkv, G, S) of the latency path's caches: batch 1 and 4, GQA, a cache
# length that is no multiple of a stage
LATENCY_CACHES = ((1, 40, 1, 1544), (4, 40, 1, 1544), (4, 8, 5, 1544),
                  (2, 40, 1, 1000))


def check_latency_kernels(gen, results, caches=LATENCY_CACHES,
                          spans=(8, 2, 5, 16), D=128):
    """The decode and verify kernels of the latency path against their
    plain versions at each of ``caches``, ragged ``pos`` and ``valid``:
    the fused bf16 kernel (its caches bit-identical to the plain
    version's), the attend-only one (equal to the fused kernel's output
    bit for bit), the int8 kernels (the fused one leaving caches
    bit-identical to the plain version's) and the verify kernels at
    ``spans`` (8 first: the latency path's draft_k). Each row is timed on
    a cold L2 (a rotation of cache copies; the fused rows write into
    them), with its device time and launches per call from a
    ``torch.profiler`` trace and the wrapper's host time per call."""
    for B, Hkv, G, S in caches:
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

        # the fused bf16 kernel against its plain version
        c1, c2 = ck.clone(), cv.clone()
        new = (xk.reshape(B, Hkv, D), xv.reshape(B, Hkv, D), pos, valid)
        fused = decode_attention_update(q.reshape(B, Hkv, G, D), c1, c2,
                                        *new)
        d1, d2 = ck.clone(), cv.clone()
        err = compare(f"decode {case}", fused, decode_attention_update_plain(
            q.reshape(B, Hkv, G, D), d1, d2, *new))
        if not (torch.equal(c1, d1) and torch.equal(c2, d2)):
            FAILURES.append(f"decode {case}: caches differ from plain")
        record(results, "decode_attention", case, err, None,
               timed_ms(lambda: decode_attention_update_plain(
                   q.reshape(B, Hkv, G, D), d1, d2, *new), reps=20),
               2 * rows * Hkv * D * 2 + nbytes(q, fused) + 2 * nbytes(xk, xv),
               4 * D * Hq * rows,
               sdpa_cold_ms(qb, dense, mask=valid_mask(valid, S)))
        time_cold(results[-1], lambda k, v: decode_attention_update(
            q.reshape(B, Hkv, G, D), k, v, *new), dense)
        del d1, d2

        # attend-only bf16: after the fused kernel wrote the row, its output
        # must equal the fused kernel's exactly
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

        for span in spans:
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


def check_vit(gen, results, crops=(20, 5)):
    """K10 at the three towers' shapes, at each of ``crops`` (20: batch 4,
    5: one request), on q, k and v as the tower block gives them: split
    views of one [B, S, 3W] projection, read in place. The device's time
    alone is printed beside the row."""
    for B in crops:
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


# The shapes phase 11 gives the kernels: InternLM2-7B's decoder linears
# (K, N of wq and wo, wk and wv, w1 and w3, w2, the head), its prefill of
# [BOS | 1295 image words | 45 ids] and its cache with grouped-query
# attention (32 query heads over 8 kv heads, G 4); the 2-image model's
# prefill of [BOS | 2910 image words | 45 ids] and a 2-image request's
# towers at 10 crops.
FAMILY_LINEARS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                  (4096, 92544))
FAMILY_PREFILL = 1 + 1295 + 45
RGBD_PREFILL = 1 + 2910 + 45


def check_families(results):
    """Phase 11's shapes, each kernel against its plain version, on inputs
    from a generator of their own: K1's GEMV at M 1 and 4 on wk/wv's
    4096x1024 and the 92544-wide head (cold L2), its tile at one InternLM2
    prefill (M 1341, 4096x4096); K2 at H32/Hkv8 over 1341 keys for batch 1
    and 4 and at H40 over 2956 keys for batch 1; the decode and verify
    kernels at G 4 for batch 1 and 4 (``check_latency_kernels``, span 9);
    K10 at the three towers' shapes at 10 crops (``check_vit``)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    for K, N in FAMILY_LINEARS[1::3]:
        qw = _quantize_leaf_int4(random_weight(K, N, gen))
        copies = weight_copies(qw)
        for M in (1, 4):
            x = randn(M, K, gen=gen)
            x2 = padded(x, qw)
            got = int4_matmul(x, qw)
            err = compare(f"int4 M={M} K={K} N={N}", got,
                          int4_matmul(x, qw, impl="plain"))
            record(results, "int4_matmul", f"M={M} K={K} N={N}",
                   err, None, timed_ms(lambda: int4_matmul_2d_plain(
                       x2, qw.q, qw.scale, qw.group), reps=1),
                   int4_bytes(qw, M, got), 2 * M * K * N,
                   timed_ms(lambda: x @ _dequantize_leaf(qw, torch.bfloat16),
                            reps=3))
            time_cold(results[-1], lambda q, s: int4_matmul_2d(
                x2, q, s, qw.group), copies)
        del copies, qw
    M, (K, N) = FAMILY_PREFILL, FAMILY_LINEARS[0]
    qw = _quantize_leaf_int4(random_weight(K, N, gen))
    x = randn(M, K, gen=gen)
    got = int4_matmul(x, qw)
    err = compare(f"int4 M={M} K={K} N={N}", got,
                  int4_matmul(x, qw, impl="plain"))
    record(results, "int4_matmul", f"M={M} K={K} N={N}", err,
           timed_ms(lambda: int4_matmul_2d(x, qw.q, qw.scale, qw.group),
                    reps=3),
           timed_ms(lambda: int4_matmul_2d_plain(x, qw.q, qw.scale,
                                                 qw.group), reps=3),
           int4_bytes(qw, M, got), 2 * M * K * N,
           timed_ms(lambda: x @ _dequantize_leaf(qw, torch.bfloat16),
                    reps=3))
    del qw

    check_flash(gen, results, ((1, 32, 8, FAMILY_PREFILL, FAMILY_PREFILL),
                               (4, 32, 8, FAMILY_PREFILL, FAMILY_PREFILL),
                               (1, 40, 40, RGBD_PREFILL, RGBD_PREFILL)))
    # InternLM2's cache 40 rows past its prefill (G 4), span 9: draft_k=8
    S = -(-(FAMILY_PREFILL + 40) // 8) * 8
    check_latency_kernels(gen, results, ((1, 8, 4, S), (4, 8, 4, S)), (9,))
    check_vit(gen, results, crops=(10,))


# The shapes phase 12 gives the kernels: Falcon-180B's decoder linears
# (K, N of wq and wo, wk and wv, dense_h_to_4h, dense_4h_to_h, the head),
# its prefill at batch 4 (the bucket of 32 ids), its loss (2 x 512), its
# cache with 232 query heads over 8 kv heads (G 29, head dim 64) at the
# length a request of 47 ids and 32 new ones fills and at 2048; and the
# families' training: InternLM2's 32 heads over 8 at 1295 image words and
# 256 ids, two sequences.
FALCON_LINEARS = ((14848, 14848), (14848, 512), (14848, 59392),
                  (59392, 14848), (14848, 65024))
FALCON_HEADS, FALCON_KV_HEADS, FALCON_HEAD_DIM = 232, 8, 64
FALCON_PROMPTS = (41, 43, 45, 47)
FALCON_CACHE = -(-(max(FALCON_PROMPTS) + 32) // 8) * 8
FALCON_LOSS_LEN = 512
INTERNLM_TRAIN_LEN = 1295 + 256


def check_falcon(results):
    """Phase 12's shapes, each kernel against its plain version, on inputs
    from a generator of their own: K1's GEMV at M 1 and 4 and its tile at
    M 1024 (the loss) on each of falcon's linears and its head, the tile
    also at M 128 (the batch-4 prefill) on wq; K2 at D 64 (232 heads over
    8) for the prefill and the loss, K9a/K9b at D 64 and at InternLM2's
    G 4; the decode kernel's D 64 instance at G 29, fused and attend-only,
    over the bf16 and the int8 cache, batch 1 and 4
    (``check_latency_kernels``)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    for K, N in FALCON_LINEARS:
        qw = _quantize_leaf_int4(random_weight(K, N, gen))
        copies = weight_copies(qw)
        for M in (1, 4, 1024) + ((128,) if (K, N) == (14848, 14848) else ()):
            x = randn(M, K, gen=gen)
            x2 = padded(x, qw)
            got = int4_matmul(x, qw)
            err = compare(f"int4 M={M} K={K} N={N}", got,
                          int4_matmul(x, qw, impl="plain"))
            gemv = M <= qmm.GEMV_MAX_M
            record(results, "int4_matmul", f"M={M} K={K} N={N}", err,
                   None if gemv else timed_ms(lambda: int4_matmul_2d(
                       x2, qw.q, qw.scale, qw.group), reps=3),
                   timed_ms(lambda: int4_matmul_2d_plain(
                       x2, qw.q, qw.scale, qw.group), reps=1),
                   int4_bytes(qw, M, got), 2 * M * K * N,
                   timed_ms(lambda: x @ _dequantize_leaf(qw, torch.bfloat16),
                            reps=3))
            if gemv:
                time_cold(results[-1], lambda q, s: int4_matmul_2d(
                    x2, q, s, qw.group), copies)
            del x, x2, got
        del copies, qw
        torch.cuda.empty_cache()
    H, Hkv, D = FALCON_HEADS, FALCON_KV_HEADS, FALCON_HEAD_DIM
    check_flash(gen, results, ((4, H, Hkv, 32, 32),
                               (2, H, Hkv, FALCON_LOSS_LEN,
                                FALCON_LOSS_LEN)), D=D)
    check_flash_bwd(gen, results, ((2, H, Hkv, FALCON_LOSS_LEN,
                                    FALCON_LOSS_LEN),), D=D)
    check_flash_bwd(gen, results, ((2, 32, 8, INTERNLM_TRAIN_LEN,
                                    INTERNLM_TRAIN_LEN),))
    G = H // Hkv
    check_latency_kernels(gen, results, ((1, Hkv, G, FALCON_CACHE),
                                         (4, Hkv, G, FALCON_CACHE),
                                         (4, Hkv, G, 2048)), (), D=D)


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
    the prompts' common prefix (after the images, if any), the model's
    cache settings and its family's ops: the device work of a step without
    the host's eager loop around it."""
    from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype

    args, lp, ops = model.args, model.decoder, model._gen_ops
    with torch.inference_mode():
        img = model.encode_images(images)
        P = min(len(t) for t in prompts)
        tokens = torch.tensor([t[:P] for t in prompts], device="cuda")
        W = 0 if img is None else img.shape[1]
        cache = ops.create_cache(
            args, len(prompts), P + W + steps + 2,
            kv_cache_dtype(model.kv_cache_bits, "cuda"), "cuda")
        logits, cache, S = ops.prefill(lp, args, cache, tokens, img, "auto")
        tok = logits.argmax(-1)[:, None]
        pos = [S]

        def step():
            ops.decode_step(lp, args, cache, tok, pos[0], "auto")
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
    PHASE4_DECODER["digest"] = decoder_digest(model.params["llama"])

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


def write_eval_tasks(root, card: str, shape=(480, 640)) -> str:
    """Phase 8's task file: 2 images x 4 questions, made from a seed. PNG
    of ``shape`` (height, width; phase 11's at 1024 px) where Pillow
    imports, else point clouds (``.npy``, xyz + rgb), which ``VQADataset``
    renders to an image; the file name routes ``fsm_for_task`` to the
    joint grammar."""
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
            pixels = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
            Image.fromarray(pixels).save(path)
        else:
            path = root / f"object{i}.npy"
            cloud = rng.uniform(-1, 1, (8192, 6)).astype(np.float32)
            cloud[:, 3:] = rng.uniform(0, 1, (8192, 3))
            np.save(path, cloud)
        paths.append(str(path))
    print(f"[{card}] eval task images: "
          + (f"PNG {shape[1]}x{shape[0]}" if Image is not None
             else "point clouds (.npy)"))
    task = root / "joint_rec_tasks.json"
    task.write_text(json.dumps([
        {"image": p, "conversations": [
            {"from": "human", "value": q},
            {"from": "gpt", "value": "<rb>revolute</rb>"
             "[0.50,0.50,0.30,0.20,0.00]"}]}
        for p in paths for q in EVAL_QUESTIONS]))
    return str(task)


def write_decoder_checkpoint(root, fan_in_scale: bool = False):
    """A full-width decoder cut to 2 layers (bf16, weights from a seed) as
    a consolidated checkpoint under ``root / "ckpt"``, written with
    ``torch.save`` beside its ``meta.json`` and ``config.json``. Returns
    the directory and the state dict (on the card). The weights are
    standard normal; with ``fan_in_scale`` every linear's are divided by
    the square root of its input width (the same draws), as an init
    scales them, so the logits and the loss stay in a trained model's
    range."""
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
    def draw(k, shape):
        w = torch.randn(*shape, generator=gen, device="cuda")
        if fan_in_scale and len(shape) == 2 and "tok_embeddings" not in k:
            w = w * shape[1] ** -0.5
        return w.to(torch.bfloat16)

    sd = {f"llma.{k}": draw(k, shape) for k, shape in shapes.items()}
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
            PHASE9_IDS["a"] = runs["a"][1]  # phase 14 (c)'s reference

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


# Phase 11: the other families at full width. The kernels each run of a
# family must launch, and the ids of phase 4's decoder (its packed head and
# first query weight summed), which (b) and (c) rebuild from the seed.
INTERNLM_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                    "decode_attention_attend", "decode_attention_q8_fused",
                    "verify_attention", "verify_attention_q8",
                    "vit_attention")
RGBD_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                "vit_attention")
TEXT_KERNELS = ("int4_matmul", "flash_attention", "decode_attention")
PHASE4_DECODER: dict = {}


def decoder_digest(decoder) -> tuple:
    """Sums of the packed head and of layer 0's packed wq: equal sums say
    two int4 decoders came from the same weights."""
    return (int(decoder["output"]["weight"].q.long().sum()),
            int(decoder["layers"][0]["attention"]["wq"]["weight"].q.long()
                .sum()))


def clip_images(n: int, size: int, seed: int):
    """n seeded size x size images, CLIP-normalized, bf16, on the card."""
    from a3vlm_tpu_torch.models import ens5

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mean = torch.tensor(ens5.CLIP_MEAN, device="cuda")
    std = torch.tensor(ens5.CLIP_STD, device="cuda")
    pixels = torch.rand(n, size, size, 3, generator=gen, device="cuda")
    return ((pixels - mean) / std).to(torch.bfloat16)


def seeded_prompts(seed: int, vocab: int, lengths) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [[1] + torch.randint(3, vocab, (n - 1,), generator=gen,
                                device="cuda").tolist() for n in lengths]


def fam_run(card: str, label: str, model, prompts, totals: dict, expect,
            **kw) -> list:
    """One greedy ``generate_tokens`` call of 32 new ids: its launches
    added to ``totals``, each kernel of ``expect`` launched, its stage
    times, peak memory and ids digest printed, the ids kept under
    ``label``."""
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats()
    outs = model.generate_tokens(prompts, max_gen_len=32, temperature=0.0,
                                 **kw)
    torch.cuda.synchronize()
    delta = launches_since(before)
    for n, c in delta.items():
        totals[n] += c
    require_counts(delta, expect, f"fam {label}")
    st = model.last_stats
    steps = max(st["decode_steps"], 1)
    print(f"[{card}] fam {label}: towers {st['towers_ms']:.1f} ms, prefill "
          f"{st['prefill_ms']:.1f} ms, decode {st['decode_ms']:.1f} ms over "
          f"{st['decode_steps']} steps ({st['decode_ms'] / steps:.2f} ms "
          f"each); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; launches { {n: c for n, c in delta.items() if c} }; "
          f"lengths {[len(o) for o in outs]}, ids digest {ids_digest(outs)}")
    if len(outs) != len(prompts) or any(
            not (0 <= t < model.true_vocab) for o in outs for t in o):
        raise AssertionError(f"fam {label}: malformed ids {outs}")
    note_ids(card, f"fam {label}", outs)
    return outs


def fam_logits(model, tokens, image_kw: dict, impl: str):
    """Prefill logits [B, V] of [BOS | image words | tokens] through one
    path (the towers too), by the family's ops."""
    ops = model._gen_ops
    with torch.inference_mode():
        img = model.encode_images(image_kw.get("images"),
                                  image_kw.get("depth_images"), impl=impl)
        W = 0 if img is None else img.shape[1]
        cache = ops.create_cache(model.args, tokens.shape[0],
                                 tokens.shape[1] + W, torch.bfloat16, "cuda")
        logits = ops.prefill(model.decoder, model.args, cache, tokens, img,
                             impl)[0]
    return img, logits


def fam_hold_ids(card: str, label: str, model, prompt, image_kw, ids, ref,
                 ref_label: str) -> None:
    """A mode's ids against the vanilla run's: equal, or else, at the first
    differing id, the kernel path's top-2 logit gap there must not exceed
    the kernel-vs-plain error of the same logits (a near tie two summation
    orders may break either way, as phase 9 holds its modes)."""
    at = first_difference(ids, ref)
    line = f"[{card}] fam {label}: ids "
    if at is None:
        print(line + f"equal to ({ref_label})'s")
        return
    toks = torch.tensor([list(prompt) + list(ref[:at])], device="cuda")
    got = fam_logits(model, toks, image_kw, "auto")[1][0, :model.true_vocab]
    want = fam_logits(model, toks, image_kw, "plain")[1][0,
                                                         :model.true_vocab]
    top = got.float().topk(2).values
    gap, err = float(top[0] - top[1]), float((got - want).abs().max())
    line += (f"first differ from ({ref_label})'s at index {at}: top-2 logit "
             f"gap {gap:.4f}, kernel vs plain max |logit diff| {err:.4f}")
    if gap > err:
        raise AssertionError(line + ": the gap exceeds the error")
    print(line)


def hold_prefill(card: str, label: str, model, prompts, image_kw) -> None:
    """The prefill logits (and image tokens) of the kernel path against the
    plain path on the same weights, phase 4's tolerance; the prompts cut to
    their prefill bucket."""
    from a3vlm_tpu_torch.generation import _prefill_bucket

    P = _prefill_bucket(min(len(p) for p in prompts))
    tokens = torch.tensor([p[:P] for p in prompts], device="cuda")
    img_k, lg_k = fam_logits(model, tokens, image_kw, "auto")
    img_p, lg_p = fam_logits(model, tokens, image_kw, "plain")
    if not (torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()):
        raise AssertionError(f"{label}: non-finite logits")
    rel = float((lg_k - lg_p).norm() / lg_p.norm())
    agree = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    line = (f"[{card}] fam {label}: prefill of {P} ids + "
            f"{model.image_words} image words at batch {len(prompts)}, "
            f"logits rel err kernel vs plain {rel:.3e} (limit "
            f"{LOGITS_REL_TOL}); first-token agreement {agree}/"
            f"{len(prompts)}")
    if img_k is not None:
        line += (f"; image tokens rel err "
                 f"{float((img_k - img_p).float().norm() / img_p.float().norm()):.3e}")
    print(line)
    if rel > LOGITS_REL_TOL:
        raise AssertionError(f"{label}: prefill logits rel err {rel:.3e}")


def write_internlm_checkpoint(root):
    """InternLM2-7B's decoder at full width cut to 2 layers, its
    ``visual_proj`` and image tags (bf16, weights from a seed) as a
    consolidated checkpoint with ``meta.json`` naming the family and a
    ``config.json`` of its decoder."""
    from a3vlm_tpu_torch.models.internlm_ems5_light import InternlmEns5Config

    cfg = InternlmEns5Config()
    args = cfg.llama.replace(n_layers=2)
    D, F_, V = args.dim, args.ffn_hidden_dim, args.vocab_size
    KV = args.kv_heads * args.head_dim
    gen = torch.Generator(device="cuda").manual_seed(10)
    shapes = {"tok_embeddings.weight": (V, D), "norm.weight": (D,),
              "output.weight": (V, D),
              "visual_proj.0.weight": (D, cfg.ens_dim),
              "visual_proj.0.bias": (D,), "visual_proj.1.weight": (D,),
              "visual_proj.1.bias": (D,), "start_img": (1, 1, D),
              "end_img": (1, 1, D)}
    for i in range(args.n_layers):
        for w, shape in (("wq", (D, D)), ("wk", (KV, D)), ("wv", (KV, D)),
                         ("wo", (D, D))):
            shapes[f"layers.{i}.attention.{w}.weight"] = shape
        for w, shape in (("w1", (F_, D)), ("w2", (D, F_)), ("w3", (F_, D))):
            shapes[f"layers.{i}.feed_forward.{w}.weight"] = shape
        for n in ("attention_norm", "ffn_norm"):
            shapes[f"layers.{i}.{n}.weight"] = (D,)
    sd = {f"llma.{k}": torch.randn(*shape, generator=gen,
                                   device="cuda").to(torch.bfloat16).cpu()
          for k, shape in shapes.items()}
    ckpt = root / "internlm_ckpt"
    ckpt.mkdir()
    torch.save({"model": sd}, ckpt / "consolidated.00-of-01.model.pth")
    (ckpt / "meta.json").write_text(json.dumps(
        {"llama_type": "internlm_ems5_light"}))
    (ckpt / "config.json").write_text(json.dumps(
        {"dim": D, "n_layers": args.n_layers, "n_heads": args.n_heads,
         "n_kv_heads": args.n_kv_heads, "vocab_size": -1}))
    return ckpt, sum(v.numel() * 2 for v in sd.values()) / 2 ** 30


def run_internlm(card: str, root, totals: dict) -> None:
    """Phase 11 (a): the released 7B's family at full width."""
    from a3vlm_tpu_torch.eval_affordance import main as eval_main
    from a3vlm_tpu_torch.meta import MetaModel

    V = 92544
    t0 = time.perf_counter()
    model = MetaModel("internlm_ems5_light", with_visual=True,
                      dtype=torch.bfloat16, tokenizer=_PieceTable(V), seed=0)
    model.quantize(bits=4)  # in place, leaf by leaf
    torch.cuda.synchronize()
    args = model.args
    print(f"[{card}] fam (a) internlm_ems5_light built in "
          f"{time.perf_counter() - t0:.1f} s (random weights, int4 decoder): "
          f"dim {args.dim}, {args.n_layers} layers, {args.n_heads} heads over "
          f"{args.kv_heads} kv heads, ffn {args.ffn_hidden_dim}, vocab "
          f"{args.vocab_size}, rope theta {args.rope_theta:g}; "
          f"{model.image_words} image words; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    if (model.image_words, args.kv_heads, args.ffn_hidden_dim) != (
            1295, 8, 14336):
        raise AssertionError("internlm_ems5_light: not the released config")
    images = clip_images(4, 1024, seed=11)
    prompts = seeded_prompts(11, V, (41, 43, 45, 47))
    # warm-up at both batches: library plans and the allocator
    model.generate_tokens(prompts, images=images, max_gen_len=2)
    model.generate_tokens(prompts[2:3], images=images[2:3], max_gen_len=2)
    fam_run(card, "(a) internlm B4", model, prompts, totals,
            RGBD_KERNELS, images=images)
    decode_profile(card, "fam (a) internlm, batch 4", model, prompts, images)
    one, img1 = prompts[2:3], {"images": images[2:3]}
    ref = fam_run(card, "(a) internlm B1 vanilla", model, one, totals,
                  ("decode_attention",), **img1)[0]
    decode_profile(card, "fam (a) internlm, batch 1", model, one,
                   img1["images"])
    dec.FUSE_UPDATE_ATTEND = False
    try:
        two = fam_run(card, "(a) internlm B1 write then attend", model, one,
                      totals, ("decode_attention_attend",), **img1)[0]
    finally:
        dec.FUSE_UPDATE_ATTEND = True
    if two != ref:
        raise AssertionError("(a) write then attend: ids differ")
    model.kv_cache_bits = 8
    q8 = fam_run(card, "(a) internlm B1 int8 cache", model, one, totals,
                 ("decode_attention_q8_fused",), **img1)[0]
    spec8 = fam_run(card, "(a) internlm B1 draft_k=8 int8 cache", model,
                    one, totals, ("verify_attention_q8",), draft_k=8,
                    **img1)[0]
    model.kv_cache_bits = None
    spec = fam_run(card, "(a) internlm B1 draft_k=8 bf16 cache", model, one,
                   totals, ("verify_attention",), draft_k=8, **img1)[0]
    print(f"[{card}] fam (a) last_spec_stats {model.last_spec_stats}")
    for label, ids, want, ref_label in (
            ("int8 cache", q8, ref, "B1 vanilla"),
            ("draft_k=8 int8 cache", spec8, q8, "B1 int8 cache"),
            ("draft_k=8 bf16 cache", spec, ref, "B1 vanilla")):
        fam_hold_ids(card, f"(a) {label}", model, one[0], img1, ids, want,
                     ref_label)
    hold_prefill(card, "(a) internlm", model, prompts, {"images": images})
    del model, images
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI on a 2-layer full-width checkpoint, 1024 px PNGs
    task = write_eval_tasks(root, card, shape=(1024, 1024))
    ckpt, size = write_internlm_checkpoint(root)
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    before = launch_counts()
    t0 = time.perf_counter()
    results = eval_main(
        ["--pretrained_path", str(ckpt), "--llama_type",
         "internlm_ems5_light", "--input_size", "1024", "--dataset", task,
         "--output_dir", str(root / "internlm_cli"), "--batch_size", "4",
         "--max_gen_len", "8", "--temperature", "0", "--quant", "--score",
         "--device", "cuda"], tokenizer=_PieceTable(V))
    secs = time.perf_counter() - t0
    delta = launches_since(before)
    for n, c in delta.items():
        totals[n] += c
    require_counts(delta, RGBD_KERNELS, "fam (a) eval CLI")
    require_no_fallback(card, "fam (a) eval CLI")
    n = hold_records(results, task, "fam (a) eval CLI")
    print(f"[{card}] fam (a) eval CLI --llama_type internlm_ems5_light "
          f"--input_size 1024 --quant --score ({size:.2f} GiB 2-layer "
          f"checkpoint): {n} records in order, {secs:.1f} s with the load; "
          f"launches { {k: delta[k] for k in RGBD_KERNELS} }")
    gc.collect()
    torch.cuda.empty_cache()


def run_rgbd_and_text(card: str, totals: dict) -> None:
    """Phase 11 (b) and (c): phase 4's 13B weights rebuilt from the seed as
    the 2-image model (two depth tags more from the same generator), then
    its packed decoder as a text-only ``llama`` model."""
    from a3vlm_tpu_torch.config import Ens5Config, ModelArgs
    from a3vlm_tpu_torch.meta import MetaModel

    t0 = time.perf_counter()
    cfg = Ens5Config(llama=ModelArgs(max_seq_len=4096))
    model = MetaModel("llama_ens5_2images", with_visual=True,
                      dtype=torch.bfloat16, tokenizer=_PieceTable(32000),
                      model_cfg=cfg, seed=0)
    model.quantize(bits=4)
    torch.cuda.synchronize()
    digest = decoder_digest(model.decoder)
    print(f"[{card}] fam (b) llama_ens5_2images built in "
          f"{time.perf_counter() - t0:.1f} s: {model.image_words} image "
          f"words; decoder digest {digest} (phase 4's "
          f"{PHASE4_DECODER.get('digest')})")
    if model.image_words != 2910 or (
            PHASE4_DECODER and digest != PHASE4_DECODER["digest"]):
        raise AssertionError("(b): not phase 4's weights or image words")
    images = clip_images(2, 448, seed=12)
    depth = clip_images(2, 448, seed=13)
    prompts = seeded_prompts(12, 32000, (43, 47))
    both = {"images": images, "depth_images": depth}
    model.generate_tokens(prompts, max_gen_len=2, **both)  # warm-up
    fam_run(card, "(b) rgbd B2", model, prompts, totals, RGBD_KERNELS,
            **both)
    fam_run(card, "(b) rgbd B1", model, prompts[:1], totals, RGBD_KERNELS,
            images=images[:1], depth_images=depth[:1])
    hold_prefill(card, "(b) rgbd", model, prompts, both)
    try:
        model.generate_tokens(prompts, images=images, max_gen_len=2)
    except ValueError as e:
        print(f"[{card}] fam (b) generate without depth_images refused: {e}")
    else:
        raise AssertionError("(b): generate without depth_images ran")

    # (c) the packed decoder as a text-only model, against the llama_ens5
    # model over the same tree given no images
    text = MetaModel("llama", params=model.decoder, model_cfg=model.args,
                     tokenizer=_PieceTable(32000))
    ens5_view = MetaModel(
        "llama_ens5", model_cfg=cfg, tokenizer=_PieceTable(32000),
        params={k: v for k, v in model.params.items() if "depth" not in k})
    prompts = seeded_prompts(14, 32000, (39, 43, 45, 49))
    text.generate_tokens(prompts, max_gen_len=2)  # warm-up
    ids = fam_run(card, "(c) llama text B4", text, prompts, totals,
                  TEXT_KERNELS)
    want = ens5_view.generate_tokens(prompts, max_gen_len=32,
                                     temperature=0.0)
    print(f"[{card}] fam (c) llama ids "
          + ("equal" if ids == want else "DIFFER from")
          + f" llama_ens5's without images (digest {ids_digest(want)})")
    if ids != want:
        raise AssertionError("(c): llama ids differ from llama_ens5's")
    del text, ens5_view, model
    gc.collect()
    torch.cuda.empty_cache()


def run_families(card: str) -> dict:
    """Phase 11; returns the kernels' launch counts of its driven runs
    (the generate calls and the CLI; not the profiles nor the checks)."""
    totals = {n: 0 for n in KERNELS}
    t11 = time.perf_counter()
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    with tempfile.TemporaryDirectory() as tmp:
        run_internlm(card, Path(tmp), totals)
    require_no_fallback(card, "fam (a)")
    run_rgbd_and_text(card, totals)
    require_no_fallback(card, "fam (b), (c)")
    require_counts(totals, INTERNLM_KERNELS, "families")
    print(f"[{card}] phase 11: {time.perf_counter() - t11:.1f} s; launches "
          f"{ {n: c for n, c in totals.items() if c} }")
    return totals


# Phase 12: falcon at full width, the families' QLoRA steps and the depth
# stream of the tower cache. Falcon-180B's decoder cut to FALCON_LAYERS of
# its 80 layers (each about 1.25 GB in int4 with group-64 scales: 80 do
# not fit the card); the kernels each of its runs must launch.
FALCON_LAYERS = 16
FALCON_VOCAB = 65024
FALCON_KERNELS = ("int4_matmul", "flash_attention", "decode_attention")
FALCON_Q8_KERNELS = ("int4_matmul", "flash_attention",
                     "decode_attention_q8_fused")
LOSS_KERNELS = ("int4_matmul", "flash_attention", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")
FAM_TRAIN_KERNELS = ("int4_matmul", "flash_attention",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def falcon_model(seed: int = 0):
    """``MetaModel("falcon")`` at ``FalconArgs()`` widths cut to
    ``FALCON_LAYERS`` layers, int4 decoder linears and head: each layer
    made from the seed on the card and quantized before the next is made,
    so no dense copy of more than one layer is ever held."""
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import falcon
    from a3vlm_tpu_torch.quant import quantize_params

    args = falcon.FalconArgs(num_layers=FALCON_LAYERS,
                             vocab_size=FALCON_VOCAB)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tree = falcon.init_falcon_params(
        dataclasses.replace(args, num_layers=0), torch.bfloat16, "cuda", gen)
    quantize_params(tree, bits=4)  # the head; the embeddings stay dense
    one = dataclasses.replace(args, num_layers=1, vocab_size=8)
    for _ in range(FALCON_LAYERS):
        layer = falcon.init_falcon_params(one, torch.bfloat16, "cuda",
                                          gen)["layers"]
        quantize_params({"layers": layer}, bits=4)
        tree["layers"] += layer
    return MetaModel("falcon", params=tree, model_cfg=args,
                     tokenizer=_PieceTable(FALCON_VOCAB), device="cuda")


def run_falcon(card: str, totals: dict) -> None:
    """Phase 12 (a): falcon served at batch 4 and 1, vanilla and with the
    int8 cache, then one loss and backward through ``MetaModel.forward``."""
    t0 = time.perf_counter()
    model = falcon_model()
    torch.cuda.synchronize()
    args = model.args
    print(f"[{card}] falcon built in {time.perf_counter() - t0:.1f} s "
          f"(random weights, int4 linears and head): hidden "
          f"{args.hidden_size}, {args.num_layers} of FalconArgs()'s 80 "
          f"layers, {args.num_attention_heads} heads over {args.kv_heads} kv "
          f"heads, head dim {args.head_dim}, MLP {4 * args.hidden_size}, "
          f"vocab {args.vocab_size}, rope theta {args.rope_theta:g}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = seeded_prompts(20, FALCON_VOCAB, FALCON_PROMPTS)
    model.generate_tokens(prompts, max_gen_len=2)  # warm-up
    d64 = {}
    before = launch_counts()
    ids = fam_run(card, "(a) falcon B4", model, prompts, totals,
                  FALCON_KERNELS)
    one = fam_run(card, "(a) falcon B1", model, prompts[2:3], totals,
                  FALCON_KERNELS)
    d64["bf16"] = launches_since(before)["decode_attention"]
    decode_profile(card, "(a) falcon B4", model, prompts, None)
    decode_profile(card, "(a) falcon B1", model, prompts[2:3], None)
    model.kv_cache_bits = 8
    before = launch_counts()
    ids8 = fam_run(card, "(a) falcon kv8 B4", model, prompts, totals,
                   FALCON_Q8_KERNELS)
    one8 = fam_run(card, "(a) falcon kv8 B1", model, prompts[2:3], totals,
                   FALCON_Q8_KERNELS)
    d64["int8"] = launches_since(before)["decode_attention_q8_fused"]
    decode_profile(card, "(a) falcon kv8 B4", model, prompts, None)
    model.kv_cache_bits = None
    for i, (got, want) in enumerate(zip(ids8 + one8, ids + one)):
        fam_hold_ids(card, f"(a) falcon kv8 row {i}", model,
                     (prompts + prompts[2:3])[i], {}, got, want, "vanilla")
    print(f"[{card}] falcon: launches of decode_cluster_kernel at head dim "
          f"64 over the served runs: bf16 cache {d64['bf16']}, int8 cache "
          f"{d64['int8']} ({FALCON_LAYERS} layers x decode steps)")
    if not (d64["bf16"] and d64["int8"]):
        raise AssertionError("falcon: the D 64 decode kernel did not launch")

    hold_prefill(card, "(a) falcon", model, prompts, {})

    # one loss and backward through MetaModel.forward (the int4 linears
    # frozen; the LayerNorms and the embeddings take gradients)
    gen = torch.Generator(device="cuda").manual_seed(21)
    examples = torch.randint(3, FALCON_VOCAB, (2, FALCON_LOSS_LEN),
                             generator=gen, device="cuda")
    examples[:, 0] = 1
    labels = examples.clone()
    labels[:, :64] = 0
    leaves = [model.decoder["word_embeddings"]["weight"]]
    for lp in model.decoder["layers"]:
        leaves += [lp[n][w] for n in ("ln_attn", "ln_mlp")
                   for w in ("weight", "bias")]
    for t in leaves:
        t.requires_grad_(True)
    before = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = model.forward(examples, labels)
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    delta = launches_since(before)
    for n, c in delta.items():
        totals[n] += c
    gnorm = float(torch.sqrt(sum(t.grad.float().pow(2).sum()
                                 for t in leaves)))
    print(f"[{card}] falcon loss and backward on 2 x {FALCON_LOSS_LEN} ids: "
          f"{ms:.1f} ms, loss {float(loss.detach()):.6f}, grad norm "
          f"{gnorm:.6f} "
          f"(embeddings and LayerNorms); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{ {n: c for n, c in delta.items() if c} }")
    require_counts(delta, LOSS_KERNELS, "falcon loss")
    if not (math.isfinite(float(loss.detach())) and math.isfinite(gnorm)):
        raise AssertionError(f"falcon loss {float(loss.detach())}, grad "
                             f"norm {gnorm}")
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()


def train_three_steps(card: str, label: str, step, state, batch,
                      tokens: int, totals: dict) -> list:
    """Three train steps on one batch: each loss and grad norm finite, the
    loss falling; prints each step's ms, loss and grad norm and the peak
    memory. Returns the losses."""
    before = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        print(f"[{card}] {label} step {i}: {ms:.1f} ms, "
              f"{tokens / ms * 1e3:.1f} tokens/s, loss {loss:.6f}, "
              f"grad_norm {gnorm:.6f}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{label}: loss {loss}, grad norm {gnorm}")
    delta = launches_since(before)
    for n, c in delta.items():
        totals[n] += c
    print(f"[{card}] {label}: peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{ {n: c for n, c in delta.items() if c} }")
    require_counts(delta, FAM_TRAIN_KERNELS, label)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    return losses


def qlora_setup(model, loss_fn, mask, lora):
    """(step, state, optimizer) of the QLoRA recipe over ``model``'s params
    and ``lora``: bf16 compute over float32 masters of the trainables,
    AdamW at lr 1e-3 with clip 8."""
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

    model.params = mixed_precision_policy(model.params, mask, torch.bfloat16)
    optimizer = make_optimizer(1e-3, max_grad_norm=8.0, weight_decay=0.0)
    step = make_train_step(loss_fn, optimizer, accum_steps=1,
                           trainable_mask=mask)
    return step, TrainState.create({**model.params, "lora": lora},
                                   optimizer, mask), optimizer


def text_batch(gen, B: int, n: int, vocab: int) -> dict:
    examples = torch.randint(3, vocab, (B, n), generator=gen, device="cuda")
    examples[:, 0] = 1
    labels = examples.clone()
    labels[:, :32] = 0
    return {"examples": examples, "labels": labels}


def run_internlm_training(card: str, totals: dict) -> None:
    """Phase 12 (b), ``internlm_ems5_light`` as released: the JAX CLI does
    not train it, so the step is ``make_train_step`` over
    ``MetaModel.forward`` (meta.py:464-484: the decoder's training forward
    over the family's image tokens): each call binds the step's params,
    cast to bf16 and with the rank-16 adapters attached to the decoder, to
    the model and takes the model's own loss. The int4 base and the towers
    stay frozen."""
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.quant import tree_map
    from a3vlm_tpu_torch.train.lora import (
        attach_lora,
        init_lora_params,
        lora_base_trainable_mask,
    )

    t0 = time.perf_counter()
    model = MetaModel("internlm_ems5_light", with_visual=True,
                      dtype=torch.bfloat16, tokenizer=_PieceTable(92544),
                      seed=0)
    model.quantize(bits=4)
    gen = torch.Generator(device="cuda").manual_seed(22)
    lora = init_lora_params(gen, model.decoder, rank=16)
    mask = tree_map(lambda _: False, model.params)
    mask["llama"] = lora_base_trainable_mask(model.decoder)
    for k in ("visual_proj", "start_img", "end_img"):
        mask[k] = tree_map(lambda _: True, model.params[k])
    mask["lora"] = tree_map(lambda _: True, lora)

    def cast(p):
        return p.to(torch.bfloat16) if (isinstance(p, torch.Tensor) and
                                        p.dtype == torch.float32) else p

    def loss_fn(params, batch):
        params = tree_map(cast, params)
        model.params = {**{k: v for k, v in params.items() if k != "lora"},
                        "llama": attach_lora(params["llama"],
                                             params["lora"])}
        return model.forward(batch["examples"], batch["labels"],
                             batch["image"])

    step, state, _ = qlora_setup(model, loss_fn, mask, lora)
    batch = {**text_batch(gen, 2, 256, 92544),
             "image": clip_images(2, 1024, seed=23)}
    torch.cuda.synchronize()
    print(f"[{card}] fam-train internlm_ems5_light built in "
          f"{time.perf_counter() - t0:.1f} s (int4 decoder, rank-16 LoRA); "
          f"batch 2 x {256 + model.image_words} tokens "
          f"({model.image_words} image words); the loss MetaModel.forward's")
    train_three_steps(card, "fam-train internlm_ems5_light", step, state,
                      batch, 2 * (256 + model.image_words), totals)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()


def run_rgbd_text_training(card: str, totals: dict) -> None:
    """Phase 12 (b), ``llama_ens5_2images`` (phase 4's 13B int4 weights
    from the seed) on an RGB and a depth stream, then its decoder as
    ``llama`` on text: the CLI's train step (``make_loss_fn``,
    ``qlora_trainable_mask``, ``--checkpointing``), which takes the depth
    stream the CLI's datasets never load."""
    from a3vlm_tpu_torch.config import Ens5Config, ModelArgs
    from a3vlm_tpu_torch.main_finetune import (
        make_loss_fn,
        qlora_trainable_mask,
    )
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.train.lora import init_lora_params

    t0 = time.perf_counter()
    model = MetaModel("llama_ens5_2images", with_visual=True,
                      dtype=torch.bfloat16, tokenizer=_PieceTable(32000),
                      model_cfg=Ens5Config(llama=ModelArgs(max_seq_len=4096)),
                      seed=0)
    model.quantize(bits=4)
    decoder = model.decoder  # int4 linears, bf16 norms, before the casts
    text = MetaModel("llama", params={**decoder}, model_cfg=model.args,
                     tokenizer=_PieceTable(32000))
    gen = torch.Generator(device="cuda").manual_seed(24)
    lora = init_lora_params(gen, decoder, rank=16)
    step, state, _ = qlora_setup(
        model, make_loss_fn(model, torch.bfloat16, remat=True),
        qlora_trainable_mask(model, lora, quant=True), lora)
    n = 128
    batch = {**text_batch(gen, 2, n, 32000),
             "image": clip_images(2, 448, seed=25),
             "depth_image": clip_images(2, 448, seed=26)}
    torch.cuda.synchronize()
    print(f"[{card}] fam-train llama_ens5_2images built in "
          f"{time.perf_counter() - t0:.1f} s; batch 2 x "
          f"{n + model.image_words} tokens ({model.image_words} image words "
          f"of two streams)")
    train_three_steps(card, "fam-train llama_ens5_2images", step, state,
                      batch, 2 * (n + model.image_words), totals)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()

    lora = init_lora_params(gen, text.decoder, rank=16)
    step, state, _ = qlora_setup(
        text, make_loss_fn(text, torch.bfloat16, remat=True),
        qlora_trainable_mask(text, lora, quant=True), lora)
    batch = text_batch(gen, 2, 2048, 32000)
    train_three_steps(card, "fam-train llama (text)", step, state, batch,
                      2 * 2048, totals)
    del text, state, step
    gc.collect()
    torch.cuda.empty_cache()


def run_depth_cache(card: str, root, totals: dict) -> None:
    """Phase 12 (c): the CLI's pieces for ``llama_ens5_2images
    --cache_tower_features`` on phase 10's 2-layer full-width checkpoint
    (its towers random from the seed): a dialog dataset with the depth
    stream (``with_depth=True``; the CLI's own datasets load none, so
    ``main`` fails on image data there as the JAX CLI does), the loader
    wrapped in ``FeatureCachingLoader`` with a depth cache, the CLI's
    loss and step. Two epochs cached (the towers run in epoch 0 only)
    against two uncached from the same state: every step's loss equal."""
    from a3vlm_tpu_torch.data.dialog import FinetuneDialogDataset
    from a3vlm_tpu_torch.data.loader import DataLoader
    from a3vlm_tpu_torch.data.sampler import FinetuneDistSampler
    from a3vlm_tpu_torch.data.transforms import get_transform
    from a3vlm_tpu_torch.main_finetune import (
        batch_to_device,
        make_loss_fn,
        qlora_trainable_mask,
    )
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.quant import tree_map
    from a3vlm_tpu_torch.train.feature_cache import (
        FeatureCachingLoader,
        TowerFeatureCache,
    )
    from a3vlm_tpu_torch.train.lora import init_lora_params
    from a3vlm_tpu_torch.train.step import TrainState

    task = write_eval_tasks(root, card)
    with open(task) as f:
        images = sorted({d["image"] for d in json.load(f)})
    (root / "rgbd.json").write_text(json.dumps([
        {"image": images[i % 2], "depth_image": images[(i + 1) % 2],
         "conversations": [
             {"from": "human", "value": EVAL_QUESTIONS[i % 4]},
             {"from": "gpt", "value": "<rb>revolute</rb>"
              "[0.50,0.50,0.30,0.20,0.00]"}]} for i in range(4)]))
    (root / "rgbd.yaml").write_text(
        f"META:\n - path: {root / 'rgbd.json'}\n   type: image_text\n")
    ckpt, sd = write_decoder_checkpoint(root)
    del sd
    model = MetaModel.from_pretrained(
        str(ckpt), llama_type="llama_ens5_2images", with_visual=True,
        max_seq_len=4096, dtype=torch.bfloat16, tokenizer=_PieceTable(32000),
        device="cuda")
    model.quantize(bits=4)
    max_words = model.image_words + 512
    ds = FinetuneDialogDataset(
        str(root / "rgbd.yaml"), transform=get_transform(
            "padded_resize", model.cfg.image_size), max_words=max_words,
        image_words=model.cfg.image_words, tokenizer=model.tokenizer,
        with_depth=True)
    sampler = FinetuneDistSampler(ds, num_replicas=1, rank=0, batch_size=2,
                                  acc_grad=1, seed=0)
    loader = DataLoader(ds, sampler, batch_size=2, accum_steps=1,
                        with_indices=True)
    gen = torch.Generator(device="cuda").manual_seed(27)
    lora = init_lora_params(gen, model.decoder, rank=16)
    mask = qlora_trainable_mask(model, lora, quant=True)
    step, state, optimizer = qlora_setup(
        model, make_loss_fn(model, torch.bfloat16, remat=True), mask, lora)
    start = tree_map(lambda t, m: t.clone() if m else t, state.params, mask)

    def run(wrapped) -> tuple:
        # the step updates the trainables in place: each run from a copy
        st = TrainState.create(tree_map(lambda t, m: t.clone() if m else t,
                                        start, mask), optimizer, mask)
        losses, k10 = [], []
        for epoch in range(2):
            sampler.set_epoch(epoch, 0)
            before = launch_counts()
            for batch in wrapped:
                st, metrics = step(st, batch_to_device(
                    batch, "cuda", torch.bfloat16))
                losses.append(float(metrics["loss"]))
            delta = launches_since(before)
            for n, c in delta.items():
                totals[n] += c
            k10.append(delta["vit_attention"])
        return losses, k10

    cached = FeatureCachingLoader(
        loader, TowerFeatureCache(model.params, model.cfg),
        depth_cache=TowerFeatureCache(model.params, model.cfg))
    t0 = time.perf_counter()
    got, k10_cached = run(cached)
    t1 = time.perf_counter()
    want, k10_plain = run(loader)
    t2 = time.perf_counter()
    print(f"[{card}] depth cache: 2 epochs of 2 steps (batch 2, "
          f"{max_words} words, RGB and depth) cached {t1 - t0:.1f} s, K10 "
          f"launches by epoch {k10_cached}, features computed "
          f"{cached.cache.computed} RGB + {cached.depth_cache.computed} "
          f"depth; uncached {t2 - t1:.1f} s, K10 {k10_plain}; losses "
          f"cached {got}, uncached {want}")
    if got != want:
        raise AssertionError("depth cache: cached losses differ")
    if k10_cached[1] or not k10_cached[0] or not all(k10_plain):
        raise AssertionError("depth cache: towers ran in a cached epoch")
    if not all(math.isfinite(x) for x in got):
        raise AssertionError(f"depth cache: losses {got}")
    del model, state, step, cached, loader, start
    gc.collect()
    torch.cuda.empty_cache()


def run_phase12(card: str) -> dict:
    """Phase 12; returns the kernels' launch counts of its runs (the
    served runs, the loss, the train steps; not the profiles nor the
    checks)."""
    totals = {n: 0 for n in KERNELS}
    t12 = time.perf_counter()
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    run_falcon(card, totals)
    require_no_fallback(card, "falcon (a)")
    t_a = time.perf_counter()
    run_internlm_training(card, totals)
    run_rgbd_text_training(card, totals)
    require_no_fallback(card, "families' training (b)")
    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_depth_cache(card, Path(tmp), totals)
    require_no_fallback(card, "depth cache (c)")
    print(f"[{card}] phase 12: {time.perf_counter() - t12:.1f} s ((a) "
          f"{t_a - t12:.1f} s, (b) {t_b - t_a:.1f} s, (c) "
          f"{time.perf_counter() - t_b:.1f} s); launches "
          f"{ {n: c for n, c in totals.items() if c} }")
    return totals



# Phase 13: ModelServer, datagen and the closed-loop gates. The kernels
# the gate path, (c) and (d), must launch: K1 (its GEMV and its tile), K2
# (with and without lse), K9a, K9b, K10, K3 fused, K7 and K8; and the
# 2-layer checkpoint's server in (a): K1, K2, K4 fused and K10.
GATE_KERNELS = ("int4_matmul", "flash_attention", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "vit_attention", "decode_attention",
                "int4_matmul_w4a8", "int4_matmul_w8a8p")
SERVER_CKPT_KERNELS = ("int4_matmul", "flash_attention",
                       "decode_attention_q8_fused", "vit_attention")


class _TokenText(_PieceTable):
    """``_PieceTable`` that also reads a prompt written as its ids
    (``PREFIX`` then the ids after BOS, space-separated), so a text prompt
    carries phase 4's token ids through ``generate`` exactly; any other
    text is encoded as the table encodes it."""

    PREFIX = "ids:"

    def encode(self, s: str, bos: bool, eos: bool) -> list[int]:
        if not s.startswith(self.PREFIX):
            return super().encode(s, bos, eos)
        ids = [int(t) for t in s[len(self.PREFIX):].split()]
        return [self.bos_id] * bos + ids + [self.eos_id] * eos

    @classmethod
    def text(cls, ids) -> str:
        """The prompt text of token ids that begin with BOS."""
        return cls.PREFIX + " ".join(str(t) for t in ids[1:])


def run_server_main(card: str, model) -> dict:
    """Phase 13 (a), first part, right after phase 4 on its model:
    ``ModelServer(meta_model=...)`` serves phase 4's four requests through
    ``generate`` (text prompts that carry phase 4's ids, ``_TokenText``),
    whose generated ids must equal phase 4's; then one ``stream_generate``,
    one ``compute_logits`` and one ``evaluate_examples``, each equal to the
    direct ``MetaModel`` call on the same inputs. Returns the launch counts
    of the ``generate`` run."""
    import numpy as np

    from a3vlm_tpu_torch.serving import ModelServer

    prompts, images = serving_inputs()
    table, tok = model.tokenizer, _TokenText(32000)
    model.tokenizer = tok
    try:
        server = ModelServer(meta_model=model)
        tok.decoded = []
        reset_launches()
        t0 = time.perf_counter()
        texts = server.generate([_TokenText.text(p) for p in prompts],
                                images=images, max_gen_len=32,
                                temperature=0.0)
        synchronize(model.device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = require_launched(SERVE_KERNELS, "ModelServer")
        ids = tok.decoded
        tok.decoded = None
        print(f"[{card}] phase 13 (a) ModelServer.generate on phase 4's "
              f"model: {len(texts)} answers in {ms:.1f} ms, ids digest "
              f"{ids_digest(ids)} (phase 4's {ids_digest(IDS['serve'])}); "
              f"launches {launches}")
        if ids != IDS["serve"]:
            raise AssertionError("ModelServer.generate: ids differ from "
                                 "phase 4's")
        one, image = _TokenText.text(prompts[0]), images[0]
        got = list(server.stream_generate(one, image=image, max_gen_len=8))
        want = list(model.stream_generate(one, image=image, max_gen_len=8))
        if got != want or not got[-1]["end_of_content"]:
            raise AssertionError("ModelServer.stream_generate differs from "
                                 "MetaModel.stream_generate")
        got = server.compute_logits([one], images=images[:1])
        want = model.compute_logits([one], images=images[:1])
        if not (len(got) == 1 and got[0].shape == want[0].shape
                == (len(prompts[0]), 32000)
                and np.array_equal(got[0], want[0])):
            raise AssertionError("ModelServer.compute_logits differs")
        ctx = _TokenText.text(prompts[0][:20])
        got = server.evaluate_examples([one], contexts=[ctx],
                                       images=images[:1])
        want = model.evaluate_examples([one], contexts=[ctx],
                                       images=images[:1])
        if (got["log_likelihood"] != want["log_likelihood"]
                or got["ppl"] != want["ppl"]
                or got["max_equal"] != want["max_equal"]
                or not np.array_equal(got["non_context_logits"][0],
                                      want["non_context_logits"][0])):
            raise AssertionError("ModelServer.evaluate_examples differs")
        print(f"[{card}] phase 13 (a) stream_generate (8 new ids at most), "
              f"compute_logits ({len(prompts[0])} x 32000) "
              f"and evaluate_examples (log-likelihood "
              f"{want['log_likelihood'][0]:.4f}) equal to MetaModel's")
    finally:
        model.tokenizer = table
        model._generator = None
    return launches


def run_server_ckpt(card: str, root) -> dict:
    """Phase 13 (a), second part: ``ModelServer(pretrained_path=..., quant=
    True, kv_cache_bits=8)`` on phase 8's 2-layer full-width checkpoint
    (written again from its seed), phase 8's task file through
    ``run_eval``: K1, K2, K4 fused and K10 launched, no fallback, the
    records in order and in the schema. Returns the launch counts."""
    from a3vlm_tpu_torch.eval_affordance import (VQADataset, _question_of,
                                                 run_eval)
    from a3vlm_tpu_torch.serving import ModelServer

    task = write_eval_tasks(root, card)
    ckpt, sd = write_decoder_checkpoint(root)
    del sd
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    t0 = time.perf_counter()
    server = ModelServer(pretrained_path=str(ckpt), quant=True,
                         kv_cache_bits=8, device="cuda",
                         tokenizer=_PieceTable(32000))
    synchronize(server.model.device)
    load_s = time.perf_counter() - t0
    ds = VQADataset(task, input_size=448)
    reset_launches()
    t0 = time.perf_counter()
    records = run_eval(server, ds, batch_size=4, max_gen_len=8,
                       temperature=0.0)
    secs = time.perf_counter() - t0
    launches = require_launched(SERVER_CKPT_KERNELS,
                                "ModelServer (2-layer checkpoint)")
    require_no_fallback(card, "ModelServer (2-layer checkpoint)")
    keys = {"answer", "format_answer", "annotation", "question", "image",
            "fail"}
    if [(r["image"], r["question"]) for r in records] != [
            (d["image"], _question_of(d)) for d in ds.data] or any(
                set(r) != keys for r in records):
        raise AssertionError("ModelServer run_eval: records out of order "
                             "or schema")
    print(f"[{card}] phase 13 (a) ModelServer(pretrained_path=<2-layer "
          f"checkpoint>, quant=True, kv_cache_bits=8): loaded in "
          f"{load_s:.1f} s; {len(records)} records in order in {secs:.1f} s;"
          f" launches { {n: launches[n] for n in SERVER_CKPT_KERNELS} }")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_datagen_full(card: str, gate) -> None:
    """Phase 13 (b): the synthetic object through datagen at the
    reference's defaults (960 px, 5 poses x 8 joint values, 32768 points a
    frame); prints each stage's seconds and the rasterizer's route, which
    must be the native one on this host."""
    import cv2

    from a3vlm_tpu_torch.datagen import rasterizer

    route = "native" if rasterizer._load_native() is not None else "numpy"
    with tempfile.TemporaryDirectory() as tmp:
        out = gate.run_datagen(tmp)
        size = sum(f.stat().st_size for f in Path(tmp, "vqa").iterdir())
        frames = len(list(Path(out["render_dir"], "101",
                               "raw_images").iterdir()))
    s = out["seconds"]
    print(f"[{card}] phase 13 (b) datagen at the reference's defaults "
          f"(960 px, {frames} frames, 32768 points a frame; cv2 "
          f"{cv2.__version__}, rasterizer {route}): render {s['render']:.2f}"
          f" s, points {s['points']:.2f} s, labels {s['label']:.2f} s; "
          f"{len(out['files'])} task files, {size / 1e6:.2f} MB")
    if route != "native":
        raise AssertionError("datagen took the numpy rasterizer: the native "
                             "one did not build")


@contextlib.contextmanager
def int4_routes():
    """Counts the K1 launches by route while it is open: ``gemv`` (M <=
    GEMV_MAX_M) and ``tile``, around the dispatcher's exact-int4 route (the
    wrapper keeps its own count)."""
    routes = qmm._INT4_ROUTES
    real = routes["v1"]
    tally = {"gemv": 0, "tile": 0}

    def counted(x, *args, **kw):
        before = int4_matmul_2d.launches
        out = real[0](x, *args, **kw)
        if int4_matmul_2d.launches > before:
            tally["gemv" if x.shape[0] <= qmm.GEMV_MAX_M else "tile"] += 1
        return out

    routes["v1"] = (counted, *real[1:])
    try:
        yield tally
    finally:
        routes["v1"] = real


def run_phase13(card: str) -> dict:
    """Phase 13 after phase 12: (a)'s 2-layer checkpoint server, (b) the
    reference-size datagen, then (c) the accuracy gate and (d) the A8 gate
    (``scripts/torch_end_task_gate.py``'s ``run_gates``). Returns the
    launch counts of the gate path, (c) and (d)."""
    from scripts import torch_end_task_gate as gate

    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_server_ckpt(card, Path(tmp))
    t_b = time.perf_counter()
    run_datagen_full(card, gate)
    t_c = time.perf_counter()
    if hasattr(qmm, "reset_fallbacks"):
        qmm.reset_fallbacks()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp, int4_routes() as routes:
        out = gate.run_gates(tmp, "cuda", max_epochs=400, tol=0.05,
                             log=lambda line: print(f"[{card}] {line}"))
    launches = launch_counts()
    lse = flash_attention_bhsd.lse_launches
    cfg = out["config"]
    print(f"[{card}] phase 13 (c) gate model: decoder dim {cfg.llama.dim}, "
          f"{cfg.llama.n_layers} layers, {cfg.llama.n_heads} heads of "
          f"{cfg.llama.head_dim}, ffn {cfg.llama.ffn_hidden_dim}, vocab "
          f"{cfg.llama.vocab_size}; towers at width {cfg.clip.width} / "
          f"{cfg.clip.heads} heads, {cfg.image_size} px images, "
          f"{cfg.image_words} image words; bf16 compute over float32 "
          f"masters, served in bf16")
    tr, sec = out["train"], out["seconds"]
    print(f"[{card}] phase 13 (c) trained {tr['epochs']} epochs "
          f"({tr['steps']} steps) to a final max batch loss "
          f"{tr['final_loss']:.6f} in {tr['seconds']:.1f} s; metrics "
          f"{json.dumps(out['accuracy'])}")
    print(f"[{card}] phase 13 (d) " + json.dumps(
        {"results": out["a8"]["results"], "verdicts": out["a8"]["verdicts"]}))
    print(f"[{card}] phase 13 (c)-(d) seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sec.items())
          + "; A8 arms " + ", ".join(
              f"{k} {v:.1f}" for k, v in out["a8"]["seconds"].items()))
    print(f"[{card}] phase 13 gate launches "
          f"{ {n: c for n, c in launches.items() if c} }; K1 by route "
          f"{routes}; flash forward with lse {lse}")
    require_counts(launches, GATE_KERNELS, "gate")
    if not (routes["gemv"] and routes["tile"]):
        raise AssertionError(f"gate: K1 routes {routes}, want both")
    if not 0 < lse < launches["flash_attention"]:
        raise AssertionError("gate: want the flash forward with and "
                             "without lse")
    require_no_fallback(card, "gate")
    if out["failures"]:
        raise AssertionError("phase 13 gates failed:\n"
                             + "\n".join(out["failures"]))
    t_end = time.perf_counter()
    print(f"[{card}] phase 13: {t_end - t13:.1f} s ((a) {t_b - t13:.1f} s, "
          f"(b) {t_c - t_b:.1f} s, (c)-(d) {t_end - t_c:.1f} s)")
    return launches


# ------------------------------------------------- 14. several ranks
# Two ranks on the one card (``devices`` naming it twice: the gloo backend,
# collectives through host memory), the caller's process rank 0.
P14_DEVICES = ["cuda:0", "cuda:0"]
# new ids a request in (a) and (c), against phase 4's and phase 9's 32: the
# host-memory collectives make a step ~0.5 s (PR 18's debug call)
P14_NEW_IDS = 8
PHASE9_IDS: dict = {}


def _rank_reset(model) -> None:
    """A rank's launch counts and fallbacks set to 0, its tokenizer
    recording the ids it decodes (``ModelServer.map_ranks``)."""
    reset_launches()
    qmm.reset_fallbacks()
    model.tokenizer.decoded = []


def _rank_state(model) -> dict:
    """A rank's ids decoded since ``_rank_reset``, launch counts by kernel,
    fallback count and peak memory (rank 0 without a mesh)."""
    mesh = model.mesh
    return {"rank": mesh.rank if mesh else 0,
            "backend": mesh.backend if mesh else "none",
            "ids": model.tokenizer.decoded,
            "launches": {n: KERNELS[n][2].launches for n in KERNELS},
            "fallbacks": qmm.fallback_count(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def p14_hold_ranks(card: str, label: str, states: list, need) -> dict:
    """Every rank's ids equal to rank 0's, each kernel of ``need``
    launched on every rank, no fallback; prints each rank's line. Returns
    rank 0's launch counts."""
    for st in states:
        launched = {n: c for n, c in st["launches"].items() if c}
        print(f"[{card}] phase 14 {label}: rank {st['rank']} backend "
              f"{st['backend']}, launches {launched}, fallbacks "
              f"{st['fallbacks']}, peak {st['peak_gib']:.2f} GiB, ids "
              f"digest {ids_digest(st['ids'])}")
        require_counts(st["launches"], need, f"phase 14 {label} rank "
                       f"{st['rank']}")
        if st["fallbacks"]:
            raise AssertionError(f"phase 14 {label}: rank {st['rank']} "
                                 f"took {st['fallbacks']} fallback routes")
        if st["ids"] != states[0]["ids"]:
            raise AssertionError(f"phase 14 {label}: rank {st['rank']}'s "
                                 "ids differ from rank 0's")
    return states[0]["launches"]


def p14_hold_ids(card: str, label: str, ids: list, ref: list,
                 ref_label: str, gap_of) -> None:
    """The sharded run's ids against one rank's (a longer run's: its ids
    cut to this run's lengths, greedy ids being prefixes of longer runs'):
    equal, or else, at the first differing id, the reference's top-2
    logit gap there must not exceed the kernel-vs-plain error of the same
    logits (``gap_of(row, at)`` gives both): the gap rule of phases 9 and
    11."""
    ref = [r[:len(g)] for g, r in zip(ids, ref)]
    rows = [i for i, (a, b) in enumerate(zip(ids, ref)) if a != b]
    line = (f"[{card}] phase 14 {label}: {len(rows)} of {len(ids)} "
            f"requests' ids differ from {ref_label}'s")
    if len(ids) != len(ref):
        raise AssertionError(line + ": request counts differ")
    if rows:
        row = rows[0]
        at = first_difference(ids[row], ref[row])
        gap, err = gap_of(row, at)
        line += (f"; first at request {row} id {at}: top-2 logit gap "
                 f"{gap:.4f}, kernel vs plain max |logit diff| {err:.4f}")
        if gap > err:
            raise AssertionError(line + ": the gap exceeds the error")
    print(line)


def run_phase14_server(card: str, model) -> dict:
    """Phase 14 (a), right after phase 4: ``ModelServer(meta_model=<phase
    4's model>, model_parallel_size=2)`` over two ranks on the card (the
    all-column int4 tree: every quantized linear split by its output
    columns) serves phase 4's four requests, 8 new ids (the collectives
    go through host memory here: ~0.5 s a step); the ids phase 4's (or
    the gap rule). Returns rank 0's launch counts."""
    import copy

    from a3vlm_tpu_torch.serving import ModelServer

    prompts, images = serving_inputs()
    served = copy.copy(model)  # the shards replace the copy's tree only
    served.tokenizer = _TokenText(32000)
    t0 = time.perf_counter()
    server = ModelServer(meta_model=served, model_parallel_size=2,
                         devices=P14_DEVICES)
    try:
        setup_s = time.perf_counter() - t0
        server.map_ranks(_rank_reset)
        t0 = time.perf_counter()
        server.generate([_TokenText.text(p) for p in prompts],
                        images=images, max_gen_len=P14_NEW_IDS,
                        temperature=0.0)
        synchronize(served.device)
        ms = (time.perf_counter() - t0) * 1e3
        states = server.map_ranks(_rank_state)
        st = served.last_stats
    finally:
        server.close()
    print(f"[{card}] phase 14 (a) ModelServer(meta_model=<phase 4's "
          f"model>, model_parallel_size=2, devices={P14_DEVICES}): "
          f"started and sharded in {setup_s:.1f} s; 4 requests in "
          f"{ms:.1f} ms (rank 0: towers {st['towers_ms']:.1f} ms, prefill "
          f"{st['prefill_ms']:.1f} ms, decode {st['decode_ms']:.1f} ms over "
          f"{st['decode_steps']} steps)")
    launches = p14_hold_ranks(card, "(a)", states, SERVE_KERNELS)
    ids = states[0]["ids"]
    IDS["mp2 serve"] = ids
    p14_hold_ids(card, "(a)", ids, IDS["serve"], "phase 4",
                 lambda row, at: logit_gap(model, prompts, images,
                                           IDS["serve"], row, at)[:2])
    return launches


def _p14_cb_rank(mesh, model, specs, task: str):
    """A rank of phase 14 (c): its shard of the model (the whole model
    where ``specs`` is None), then ``run_eval_continuous`` over the task
    file through ``ContinuousBatcher(mesh=)`` (``_TimedBatcher`` in its
    place, as in phase 9)."""
    from a3vlm_tpu_torch.eval_affordance import (VQADataset,
                                                 run_eval_continuous)
    from a3vlm_tpu_torch.serving import _take_shard

    if specs is not None:
        _take_shard(model, mesh, specs)
    real = serving_batch.ContinuousBatcher
    serving_batch.ContinuousBatcher = _TimedBatcher
    _TimedBatcher.spd = 1
    _TimedBatcher.log = []
    try:
        ds = VQADataset(task, input_size=model.cfg.image_size)
        _rank_reset(model)
        torch.cuda.reset_peak_memory_stats()
        synchronize(model.device)
        t0 = time.perf_counter()
        records = run_eval_continuous(model, ds, batch_size=4,
                                      max_gen_len=P14_NEW_IDS,
                                      temperature=0.0)
        synchronize(model.device)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        serving_batch.ContinuousBatcher = real
    state = _rank_state(model)
    state["ids"] = [row for e in _TimedBatcher.log if e[0] == "generate"
                    for row in e[1]]
    state.update(records=records, wall_ms=wall, steps=[
        e[3] for e in _TimedBatcher.log if e[0] == "generate"])
    return state


def run_phase14_cb(card: str, model) -> dict:
    """Phase 14 (c), right after phase 9: ``ContinuousBatcher(mesh=)`` at
    mp 2, driven SPMD (every rank shards phase 4's model, builds the
    batcher through ``run_eval_continuous`` and steps it) over phase 9's
    task file, 8 new ids a request; the ids phase 9 (a)'s (or the gap
    rule). Returns rank 0's launch counts."""
    import copy

    from a3vlm_tpu_torch.eval_affordance import VQADataset
    from a3vlm_tpu_torch.parallel.launch import run_spmd
    from a3vlm_tpu_torch.serving import partition_specs

    served = copy.copy(model)
    served.tokenizer = _PieceTable(32000)
    specs = partition_specs(model, 2)
    with tempfile.TemporaryDirectory() as tmp:
        task = write_eval_tasks(Path(tmp), card)
        t0 = time.perf_counter()
        states = run_spmd(_p14_cb_rank, P14_DEVICES, served, specs, task,
                          model_parallel_size=2)
        secs = time.perf_counter() - t0
        ds = VQADataset(task, input_size=model.cfg.image_size)
        print(f"[{card}] phase 14 (c) ContinuousBatcher(mesh=) at mp 2 on "
              f"phase 9's task file: {secs:.1f} s with the ranks' start; "
              f"run_eval_continuous {states[0]['wall_ms']:.1f} ms on rank "
              f"0, steps {states[0]['steps']}")
        launches = p14_hold_ranks(card, "(c)", states, CB_KERNELS)
        if any(st["records"] != states[0]["records"] for st in states):
            raise AssertionError("phase 14 (c): records differ by rank")
        ids = states[0]["ids"]
        IDS["mp2 cb"] = ids
        p14_hold_ids(card, "(c)", ids, PHASE9_IDS["a"], "phase 9 (a)",
                     lambda row, at: cb_logit_gap(model, ds[row],
                                                  PHASE9_IDS["a"][row], at))
    return launches


def run_phase14_ckpt(card: str) -> dict:
    """Phase 14 (b), after phase 13: phase 8's 2-layer full-width
    checkpoint through ``ModelServer(pretrained_path=..., quant=True,
    model_parallel_size=2)``, the chunk-packed row-parallel tree (wo and w2
    in 2 chunks of group 32, a chunk a rank, the partials all-reduced),
    against the same tree on one rank (``quantize(tp_align=256,
    row_parallel=2)``), phase 8's task file through ``run_eval``. Returns
    rank 0's launch counts."""
    from a3vlm_tpu_torch.eval_affordance import VQADataset, run_eval
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.serving import ModelServer

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        task = write_eval_tasks(root, card)
        ckpt, sd = write_decoder_checkpoint(root)
        del sd
        ds = VQADataset(task, input_size=448)
        one = MetaModel.from_pretrained(str(ckpt), with_visual=True,
                                        vocab_align=256, device="cuda",
                                        tokenizer=_PieceTable(32000))
        one.quantize(tp_align=256, row_parallel=2)
        w2 = one.params["llama"]["layers"][0]["feed_forward"]["w2"]["weight"]
        one.tokenizer.decoded = []
        run = dict(batch_size=4, max_gen_len=8, temperature=0.0)
        run_eval(one, ds, **run)
        ref = one.tokenizer.decoded
        t0 = time.perf_counter()
        server = ModelServer(pretrained_path=str(ckpt), quant=True,
                             model_parallel_size=2, devices=P14_DEVICES,
                             tokenizer=_PieceTable(32000))
        try:
            setup_s = time.perf_counter() - t0
            server.map_ranks(_rank_reset)
            t0 = time.perf_counter()
            records = run_eval(server, ds, **run)
            secs = time.perf_counter() - t0
            states = server.map_ranks(_rank_state)
        finally:
            server.close()
        print(f"[{card}] phase 14 (b) ModelServer(pretrained_path=<2-layer "
              f"checkpoint>, quant=True, model_parallel_size=2): w2 "
              f"{w2.k_chunks} chunks of {2 * w2.q.shape[-2]} rows, group "
              f"{w2.group}; loaded, quantized and sharded in {setup_s:.1f} "
              f"s; {len(records)} records in {secs:.1f} s")
        launches = p14_hold_ranks(card, "(b)", states, ("int4_matmul",
                                                        "flash_attention",
                                                        "decode_attention",
                                                        "vit_attention"))
        ids = states[0]["ids"]
        IDS["mp2 ckpt"] = ids
        p14_hold_ids(card, "(b)", ids, ref, "one rank's (the same tree)",
                     lambda row, at: cb_logit_gap(one, ds[row], ref[row],
                                                  at))
        del one
    gc.collect()
    torch.cuda.empty_cache()
    return launches


P15_STEPS = 3
P15_KERNELS = ("int4_matmul", "flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "vit_attention")
# the first update against one rank's: the same weights and batch, bf16
# sums in another order (the row products' partials summed over ranks in
# float32, then rounded once); the later ones after updates that differ by
# as much, and grad norms, which sum every element's square
P15_FIRST_REL_TOL = 2e-3
P15_LATER_REL_TOL = 2e-2


def _p15_rank_report() -> dict:
    """A rank's kernel launches and fallbacks, after the CLI's run (its
    ``rank_report``)."""
    return {"launches": {n: KERNELS[n][2].launches for n in KERNELS},
            "fallbacks": qmm.fallback_count()}


def _p15_collective_ms(prof) -> dict:
    """ms of rank 0's host in each collective (``collective:*`` spans of
    ``parallel/mesh.py``) over a profile."""
    out = {}
    for evt in prof.key_averages():
        if evt.key.startswith("collective:"):
            out[evt.key.split(":", 1)[1]] = evt.cpu_time_total / 1e3
    return out


def _p15_same_leaves(live, stored, path="") -> int:
    """torch.equal of every stored leaf (``None``: not stored) and the
    live tree's leaf at its place; returns how many were compared."""
    if stored is None:
        return 0
    if isinstance(stored, dict):
        return sum(_p15_same_leaves(live[k], v, f"{path}/{k}")
                   for k, v in stored.items())
    if isinstance(stored, (list, tuple)):
        return sum(_p15_same_leaves(a, b, f"{path}/{i}")
                   for i, (a, b) in enumerate(zip(live, stored)))
    if not torch.equal(live, stored.to(live.device, live.dtype)):
        raise AssertionError(f"phase 15 (c): restored {path} differs from "
                             "the saved leaf")
    return 1


def run_phase15(card: str) -> dict:
    """Phase 15, after phase 14 (b): the training CLI on two ranks of this
    card (gloo), phase 8's 2-layer full-width checkpoint (towers from the
    seed; the linears at an init's scale), QLoRA rank 16, accumulation 2,
    remat, 3 updates of a global batch of 2: one rank, then (a) data 2 x model 1 and (b) data 1 x model
    2 (the all-column int4 tree), each held against one rank's losses and
    grad norms, with every rank's launches and no fallback; (c) (b)'s
    checkpoint resumed on one rank equals the saved files leaf for leaf.
    Returns rank 0's launch counts of (a) and (b)."""
    from a3vlm_tpu_torch import main_finetune
    from a3vlm_tpu_torch.checkpoint.bridge import params_from_host

    totals = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        task = write_eval_tasks(root, card)
        with open(task) as f:
            images = sorted({d["image"] for d in json.load(f)})
        n = P15_STEPS * 2 * 2
        (root / "dialog.json").write_text(json.dumps([
            {"image": images[i % 2], "conversations": [
                {"from": "human", "value": EVAL_QUESTIONS[i % 4]},
                {"from": "gpt", "value": "<rb>revolute</rb>"
                 f"[0.{i:02d},0.50,0.30,0.20,0.00]"}]} for i in range(n)]))
        (root / "data.yaml").write_text(
            f"META:\n - path: {root / 'dialog.json'}\n   type: image_text\n")
        # phase 8's checkpoint at an init's scale: its unit-variance
        # weights give a loss of ~300, which bf16 rounding moves by ~1%
        ckpt, sd = write_decoder_checkpoint(root, fan_in_scale=True)
        del sd
        gc.collect()
        torch.cuda.empty_cache()
        argv = ["--tokenizer_path", str(ckpt), "--data_config",
                str(root / "data.yaml"), "--dialog", "--pretrained_path",
                str(ckpt), "--quant", "--lora_rank", "16",
                "--only_save_trainable", "--checkpointing", "--accum_iter",
                "2", "--epochs", "1", "--lr", "1e-4", "--min_lr", "1e-4",
                "--warmup_epochs", "0", "--print_freq", "1", "--device",
                "cuda"]
        runs = {"one rank": ["--batch_size", "2"],
                "(a) data 2 x model 1": [
                    "--batch_size", "1", "--num_devices", "2", "--devices",
                    ",".join(P14_DEVICES)],
                "(b) data 1 x model 2": [
                    "--batch_size", "2", "--model_parallel_size", "2",
                    "--devices", ",".join(P14_DEVICES)]}
        ref = None
        for i, (label, extra) in enumerate(runs.items()):
            out = root / f"run{i}"
            reset_launches()
            qmm.reset_fallbacks()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as prof:
                reports = main_finetune.train(
                    argv + extra + ["--output_dir", str(out)],
                    tokenizer=_PieceTable(32000),
                    rank_report=_p15_rank_report)[1]
            secs = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            steps = reports[0]["steps"]
            step_ms = [s["seconds"] * 1e3 for s in steps]
            coll = _p15_collective_ms(prof)
            share = sum(coll.values()) / sum(step_ms) if coll else 0.0
            print(f"[{card}] phase 15 {label}: {secs:.1f} s with the ranks' "
                  f"start and the loads; steps "
                  + ", ".join(f"{ms:.1f} ms (loss {s['loss']:.6f}, grad_norm "
                              f"{s['grad_norm']:.6f})"
                              for ms, s in zip(step_ms, steps))
                  + f"; rank 0's host in collectives {sum(coll.values()):.1f}"
                  f" ms ({share:.1%} of the steps' wall; "
                  + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
                      coll.items())) + ")")
            if len(steps) != P15_STEPS or not all(
                    math.isfinite(s["loss"]) for s in steps):
                raise AssertionError(f"phase 15 {label}: steps {steps}")
            for rep in reports:
                launched = {k: c for k, c in rep["launches"].items() if c}
                print(f"[{card}] phase 15 {label}: rank {rep['rank']} "
                      f"updates " + ", ".join(
                          f"{s['seconds'] * 1e3:.1f}" for s in rep["steps"])
                      + f" ms, peak {rep['peak_gib']:.2f} GiB, fallbacks "
                      f"{rep['fallbacks']}, replicated trainables' digest "
                      f"{rep['replicas']}, launches {launched}")
                require_counts(rep["launches"], P15_KERNELS,
                               f"phase 15 {label} rank {rep['rank']}")
                if rep["fallbacks"]:
                    raise AssertionError(f"phase 15 {label}: rank "
                                         f"{rep['rank']} took "
                                         f"{rep['fallbacks']} fallbacks")
            if ref is None:
                ref = steps
                continue
            for n_step, (got, want) in enumerate(zip(steps, ref)):
                for key in ("loss", "grad_norm"):
                    rel = abs(got[key] - want[key]) / abs(want[key])
                    tol = (P15_FIRST_REL_TOL if n_step == 0 and key == "loss"
                           else P15_LATER_REL_TOL)
                    if rel > tol:
                        raise AssertionError(
                            f"phase 15 {label}: step {n_step} {key} "
                            f"{got[key]} against one rank's {want[key]} "
                            f"(rel {rel:.3e} > {tol})")
            print(f"[{card}] phase 15 {label}: losses and grad norms within "
                  f"{P15_FIRST_REL_TOL} (first loss) / {P15_LATER_REL_TOL} "
                  f"of one rank's; replicated trainables the same bytes on "
                  f"every rank")
            for k, c in reports[0]["launches"].items():
                totals[k] += c
        # (c) (b)'s checkpoint resumed on one rank: its tree is the files'
        saved = root / "run2" / "epoch_0"
        t0 = time.perf_counter()
        state, _ = main_finetune.train(
            argv + ["--batch_size", "2", "--resume", str(saved),
                    "--output_dir", str(root / "resumed")],
            tokenizer=_PieceTable(32000))
        stored = params_from_host(torch.load(saved / "model.pt",
                                             weights_only=True),
                                  device="cuda")
        opt = torch.load(saved / "optimizer.pt", weights_only=True)
        n_leaves = _p15_same_leaves(state.params, stored)
        for key in ("mu", "nu"):
            n_leaves += _p15_same_leaves(getattr(state.opt_state, key),
                                         params_from_host(opt[key],
                                                          device="cuda"))
        if not state.opt_state.count == opt["count"] == P15_STEPS:
            raise AssertionError("phase 15 (c): the update count differs")
        print(f"[{card}] phase 15 (c) (b)'s epoch_0 resumed on one rank in "
              f"{time.perf_counter() - t0:.1f} s: {n_leaves} leaves "
              f"(trainables and both moments) equal to the saved ones "
              f"(torch.equal), update count {state.opt_state.count}")
        del state, stored, opt
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def print_rows(card: str, results: list) -> None:
    """Prints phase 3's rows: error, kernel, plain, bound and library ms,
    and for the tensor-core kernels their rate and share of the bound."""
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
        check_flash_samples()
        check_flash_extension(gen, results)
        check_flash_bwd(gen, results)
        check_decode(gen, results)
        check_latency_kernels(gen, results)
        check_vit(gen, results)
        check_families(results)
        check_falcon(results)
        check_mptrain(results)
    print_rows(card, results)
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
    # 13. (a) ModelServer on phase 4's model
    run_server_main(card, model)
    require_no_fallback(card, "ModelServer")
    # 14. (a) the same model split over two ranks
    t14 = time.perf_counter()
    p14 = run_phase14_server(card, model)
    t14 = time.perf_counter() - t14
    evals, lockstep = run_eval_path(card, model)
    print(f"[{card}] launches in the eval path: "
          f"{ {n: evals[n] for n in EVAL_KERNELS} }")
    cb = run_cb_path(card, model, lockstep)
    require_no_fallback(card, "continuous batching")
    # 14. (c) the slot pool split over two ranks
    t = time.perf_counter()
    for n, c in run_phase14_cb(card, model).items():
        p14[n] += c
    t14 += time.perf_counter() - t
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
    gc.collect()
    torch.cuda.empty_cache()
    # 11. the other families at full width
    fam = run_families(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 12. falcon, the families' training and the depth cache
    p12 = run_phase12(card)
    gc.collect()
    torch.cuda.empty_cache()
    # 13. ModelServer from a checkpoint, datagen and the gates
    p13 = run_phase13(card)
    # 14. (b) the row-parallel tree of a checkpoint over two ranks
    t = time.perf_counter()
    for n, c in run_phase14_ckpt(card).items():
        p14[n] += c
    t14 += time.perf_counter() - t
    print(f"[{card}] phase 14: {t14:.1f} s")
    # 15. training on two ranks of the card through the CLI
    t15 = time.perf_counter()
    p15 = run_phase15(card)
    print(f"[{card}] phase 15: {time.perf_counter() - t15:.1f} s")

    table = []
    for name, (source, replaces, _) in KERNELS.items():
        mine = [r for r in results if r["name"] == name]
        by_path = {"serve": serve.get(name, 0),
                   "cb": cb.get(name, 0),
                   "latency": latency.get(name, 0),
                   "train": train.get(name, 0),
                   "quant": quant.get(name, 0),
                   "ckpt": ckpt.get(name, 0),
                   "fam": fam.get(name, 0),
                   "p12": p12.get(name, 0),
                   "gate": p13.get(name, 0),
                   "mp": p14.get(name, 0),
                   "mptrain": p15.get(name, 0)}
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
