"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles the hand-written kernels (a3vlm_tpu_torch/csrc) with
   nvcc and prints the build time.
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the main path gives it; prints error and times.
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

The line before the last is the kernel table as JSON (``launches`` sums
the serving and training runs, ``launches_by_path`` splits them); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from a3vlm_tpu_torch.ops import _kernels
from a3vlm_tpu_torch.ops.decode_attention import (
    decode_attention_update,
    decode_attention_update_plain,
)
from a3vlm_tpu_torch.ops.flash_attention import (
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
)
from a3vlm_tpu_torch.ops.quant_matmul import (
    int4_matmul,
    int4_matmul_2d,
    int4_matmul_2d_plain,
)
from a3vlm_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
from a3vlm_tpu_torch.quant import _quantize_leaf_int4

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
}
SERVE_KERNELS = ("int4_matmul", "flash_attention", "decode_attention",
                 "vit_attention")
TRAIN_KERNELS = ("int4_matmul", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "vit_attention")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


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


FAILURES: list[str] = []


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
        results.append(("int4_matmul", f"M={M} K={K}(pad {kpad}) N={N}",
                        err, ms, plain))


def check_flash(gen, results):
    for B, Hq, Hkv, Sq, Skv in ((4, 40, 40, 1487, 1487),
                                (4, 40, 8, 1487, 1487),
                                (4, 40, 40, 512, 1487)):
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
        results.append(("flash_attention",
                        f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D}",
                        err, ms, plain))


def check_flash_bwd(gen, results):
    """K2 with its lse and K9a/K9b at the training shapes (B 2, S 2048),
    GQA and right-aligned; both backward sides get the kernel's output and
    lse."""
    for B, Hq, Hkv, Sq, Skv in ((2, 40, 40, 2048, 2048),
                                (2, 40, 8, 2048, 2048),
                                (2, 40, 40, 512, 2048)):
        D = 128
        case = f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} D={D}"
        q = randn(B, Hq, Sq, D, gen=gen)
        k = randn(B, Hkv, Skv, D, gen=gen)
        v = randn(B, Hkv, Skv, D, gen=gen)
        do = randn(B, Hq, Sq, D, gen=gen)
        out, lse = flash_attention_bhsd(q, k, v, True, return_lse=True)
        _, want_lse = flash_attention_bhsd_plain(q, k, v, True,
                                                 return_lse=True)
        err = compare(f"flash lse {case}", lse, want_lse)
        ms = timed_ms(lambda: flash_attention_bhsd(q, k, v, True,
                                                   return_lse=True))
        plain = timed_ms(lambda: flash_attention_bhsd_plain(
            q, k, v, True, return_lse=True), reps=3)
        results.append(("flash_attention", f"lse {case}", err, ms, plain))

        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, True)
        err = compare(f"bwd dq {case}", flash_attention_bwd_dq(*args),
                      flash_attention_bwd_dq_plain(*args))
        ms = timed_ms(lambda: flash_attention_bwd_dq(*args))
        plain = timed_ms(lambda: flash_attention_bwd_dq_plain(*args), reps=3)
        results.append(("flash_attention_bwd_dq", case, err, ms, plain))

        got = flash_attention_bwd_dkv(*args)
        want = flash_attention_bwd_dkv_plain(*args)
        err = max(compare(f"bwd dk {case}", got[0], want[0]),
                  compare(f"bwd dv {case}", got[1], want[1]))
        del got, want
        ms = timed_ms(lambda: flash_attention_bwd_dkv(*args))
        plain = timed_ms(lambda: flash_attention_bwd_dkv_plain(*args),
                         reps=3)
        results.append(("flash_attention_bwd_dkv", case, err, ms, plain))


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
    results.append(("decode_attention",
                    f"B={B} Hkv={Hkv} G={G} S={S} D={D}", err, ms, plain))


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
        results.append(("vit_attention", f"B={B} S={S} H={H} D={D}", err,
                        ms, plain))


def reset_launches() -> None:
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    flash_attention_bhsd.lse_launches = 0


def require_launched(names, path: str) -> dict:
    launches = {n: KERNELS[n][2].launches for n in names}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")
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
        device="cuda",
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


def main() -> int:
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

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    with torch.inference_mode():
        check_int4(gen, results)
        check_flash(gen, results)
        check_flash_bwd(gen, results)
        check_decode(gen, results)
        check_vit(gen, results)
    for name, case, err, ms, plain in results:
        print(f"[{card}] {name:23s} {case:44s} max_abs_err {err:.3e} "
              f"kernel {ms:.4f} ms plain {plain:.4f} ms")
    if FAILURES:
        raise AssertionError("kernel checks failed:\n" + "\n".join(FAILURES))

    # 4. serving path, 5. training path
    model, serve = run_main_path(card)
    train = run_training(card, model)

    table = []
    for name, (source, replaces, _) in KERNELS.items():
        mine = [r for r in results if r[0] == name]
        by_path = {"serve": serve.get(name, 0), "train": train.get(name, 0)}
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r[2] for r in mine),
            "ms": mine[0][3], "plain_ms": mine[0][4],
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
