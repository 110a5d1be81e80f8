"""Smoke run of the port's serving on several cards: four NVIDIA GPUs of one
host joined by NVLink, one rank a card, NCCL between them.

    python3 scripts/torch_multichip_smoke.py [--phases k,a,cli,b,c,t]

(k) the kernels at the per-rank shapes of (a)-(c), on the first card,
    each against its plain version, timed with its bound, plain and
    library times as chip_smoke's phase 3 times its rows.

(a) the 13B ``llama_ens5`` int4 at full width (random weights from a seed,
    4 towers) served the way ``eval_affordance --model_parallel_size``
    serves it, ``ModelServer(meta_model=...)``: data 2 x model 2 and
    1 x 4, over chip_smoke's phase-8 task file through ``run_eval``; the
    ids held against one card's (equal, or the gap rule of chip_smoke's
    phases 9 and 11). (cli) ``eval_affordance.main --model_parallel_size
    2`` and ``4`` themselves on a 2-layer full-width checkpoint.
(b) ``ContinuousBatcher(mesh=)`` at mp 4 (every rank building and stepping
    the batcher through ``run_eval_continuous``) over the same task file,
    held against one card's.
(c) Falcon-180B (``FalconArgs()``) at its full 80 layers, int4, at mp 4:
    each rank makes each layer on its card from (seed, layer), quantizes
    it with wo and dense_4h_to_h row-parallel (``row_parallel=4``) and
    keeps its slice; then 4 prompts at batch 4 and one at batch 1, 32 new
    ids, with the bf16 and the int8 cache. Before it, the 16-layer cut of
    chip_smoke's phase 12 (a) (the same weights, all-column int4) at mp 4,
    held against the same model on one card.

(t) training: chip_smoke's phase 5 QLoRA step (the 13B at full width,
    rank 16, remat, a batch of 2 x 2048 tokens, 4 updates, the same seeds)
    at data 2 x model 2 and at data 1 x model 4, every rank building the
    model on its card and keeping its shard (``tp_align`` of the mesh: the
    all-column int4 tree), held against the same 4 updates on one card
    (losses within a relative 2e-3 on the first update, 2e-2 later); the
    2 x 2 state saved (rank 0 writes the gathered leaves) and restored at
    1 x 4 over its own trained state, every restored trainable and moment
    equal to the file's. Each
    update's ms, rank 0's host time in the collectives (``torch.profiler``
    spans) and each rank's peak memory, launches and fallbacks. (k) adds
    the rows of K1's tile at a model-4 rank's training shapes and K2 /
    K9a / K9b at its 10 heads.

Printed for each: prefill ms, a decode step's wall ms, each rank's device
ms of one decode step and the collectives' share of it (``torch.profiler``
kernel names), peak memory a rank, each rank's kernel launches and
fallbacks; every rank's ids must equal rank 0's. Exits non-zero on any
failure. The first line is the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from a3vlm_tpu_torch.ops import _kernels  # noqa: E402
from a3vlm_tpu_torch.ops import quant_matmul as qmm  # noqa: E402
from a3vlm_tpu_torch.parallel.mesh import use_mesh  # noqa: E402

DEVICES = [f"cuda:{i}" for i in range(4)]
COLLECTIVES = ("nccl",)


def cards() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return " | ".join(line.strip() for line in out.stdout.splitlines())


def step_profile(model, prompts, images, steps: int = 4) -> dict:
    """A rank's device time of one decode step (``torch.profiler`` over
    ``steps`` steps after a warm-up step) on a cache prefilled with the
    prompts' common prefix, with every batch row on every rank (the model
    axis's step), split into the collectives (NCCL kernels) and the rest."""
    from a3vlm_tpu_torch.ops.decode_attention import kv_cache_dtype

    args, lp, ops = model.args, model.decoder, model._gen_ops
    with torch.inference_mode(), use_mesh(model.mesh):
        img = model.encode_images(images) if images is not None else None
        P = min(len(t) for t in prompts)
        tokens = torch.tensor([t[:P] for t in prompts], device=model.device)
        W = 0 if img is None else img.shape[1]
        cache = ops.create_cache(
            args, len(prompts), P + W + steps + 2,
            kv_cache_dtype(model.kv_cache_bits, model.device), model.device)
        logits, cache, S = ops.prefill(lp, args, cache, tokens, img, "auto")
        tok = logits.argmax(-1)[:, None]
        pos = [S]

        def step():
            ops.decode_step(lp, args, cache, tok, pos[0], "auto")
            pos[0] += 1

        step()
        torch.cuda.synchronize()
        cs.kernel_times(step, 1)  # the profiler's own start-up, untimed
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        torch.distributed.barrier()
        times = cs.kernel_times(step, steps)
    total = sum(t for t, _ in times.values())
    coll = sum(t for k, (t, _) in times.items()
               if any(c in k.lower() for c in COLLECTIVES))
    return {"rank": model.mesh.rank, "device_ms": total,
            "collective_ms": coll, "wall_ms": wall,
            "collective_calls": sum(n for k, (_, n) in times.items()
                                    if any(c in k.lower()
                                           for c in COLLECTIVES))}


def _profile_rank(model, prompts, images):
    return step_profile(model, prompts, images)


def print_profiles(card: str, label: str, profs: list) -> None:
    """A decode step a rank: wall ms (the loop's step alone), device ms,
    the NCCL kernels' ms and count (their time includes waiting for the
    slowest rank to arrive), and the rest, the rank's own compute."""
    for p in profs:
        share = p["collective_ms"] / max(p["device_ms"], 1e-9)
        print(f"[{card}] {label}: rank {p['rank']} one decode step wall "
              f"{p['wall_ms']:.2f} ms, device {p['device_ms']:.4f} ms: "
              f"collectives {p['collective_ms']:.4f} ms in "
              f"{p['collective_calls']:g} NCCL kernels ({share:.1%}), "
              f"compute {p['device_ms'] - p['collective_ms']:.4f} ms")


# ---------------------------------------------------------------- (a)


def run_a(card: str, task: str) -> None:
    """The 13B served at data 2 x model 2 and 1 x 4."""
    from a3vlm_tpu_torch.config import Ens5Config
    from a3vlm_tpu_torch.eval_affordance import VQADataset, run_eval
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.serving import ModelServer

    t0 = time.perf_counter()
    model = MetaModel("llama_ens5", with_visual=True, max_seq_len=2048,
                      dtype=torch.bfloat16, tokenizer=cs._PieceTable(32000),
                      model_cfg=Ens5Config(), seed=0, device="cuda:0")
    # the CLI's tp_align of mp 2 and 4 pads nothing at the 13B's widths
    model.quantize(bits=4, tp_align=512)
    print(f"[{card}] (a) 13B int4 built on cuda:0 in "
          f"{time.perf_counter() - t0:.1f} s")
    ds = VQADataset(task, input_size=448)
    run = dict(batch_size=4, max_gen_len=32, temperature=0.0)
    run_eval(model, ds, batch_size=4, max_gen_len=2, temperature=0.0)
    model.tokenizer.decoded = []
    t0 = time.perf_counter()
    ref_records = run_eval(model, ds, **run)
    one_s = time.perf_counter() - t0
    ref = model.tokenizer.decoded
    model.tokenizer.decoded = None
    st = model.last_stats
    print(f"[{card}] (a) one card: {len(ref_records)} records in "
          f"{one_s:.1f} s; last batch prefill {st['prefill_ms']:.1f} ms, "
          f"decode {st['decode_ms'] / max(st['decode_steps'], 1):.2f} ms a "
          f"step; ids digest {cs.ids_digest(ref)}")
    prompts, images = cs.serving_inputs()
    images = images.float().cpu().numpy()  # each rank takes them to its card
    for mp in (2, 4):
        label = f"(a) data {4 // mp} x model {mp}"
        served = copy.copy(model)
        served.tokenizer = cs._PieceTable(32000)
        t0 = time.perf_counter()
        server = ModelServer(meta_model=served, model_parallel_size=mp,
                             devices=DEVICES)
        try:
            setup = time.perf_counter() - t0
            run_eval(server, ds, batch_size=4, max_gen_len=2,
                     temperature=0.0)
            server.map_ranks(cs._rank_reset)
            t0 = time.perf_counter()
            records = run_eval(server, ds, **run)
            secs = time.perf_counter() - t0
            st = served.last_stats
            states = server.map_ranks(cs._rank_state)
            profs = server.map_ranks(_profile_rank, prompts, images)
        finally:
            server.close()
        print(f"[{card}] {label}: backend {states[0]['backend']}, started "
              f"and sharded in {setup:.1f} s; {len(records)} records in "
              f"{secs:.1f} s; last batch prefill {st['prefill_ms']:.1f} ms, "
              f"decode {st['decode_ms']:.1f} ms over {st['decode_steps']} "
              f"steps = {st['decode_ms'] / max(st['decode_steps'], 1):.2f} "
              f"ms a step (wall)")
        cs.p14_hold_ranks(card, label, states, cs.SERVE_KERNELS)
        print_profiles(card, label, profs)
        cs.p14_hold_ids(card, label, states[0]["ids"], ref, "one card",
                        lambda row, at: cs.cb_logit_gap(model, ds[row],
                                                        ref[row], at))
    del model, served
    gc.collect()
    torch.cuda.empty_cache()


def run_cli(card: str, task: str, ckpt_root: Path) -> None:
    """``eval_affordance.main`` at mp 1, 2 and 4 on a 2-layer full-width
    checkpoint."""
    from a3vlm_tpu_torch.eval_affordance import main

    ckpt, sd = cs.write_decoder_checkpoint(ckpt_root)
    del sd
    outs = {}
    for mp in (1, 2, 4):
        argv = ["--pretrained_path", str(ckpt), "--dataset", task,
                "--quant", "--batch_size", "4", "--max_gen_len", "8",
                "--temperature", "0", "--output_dir",
                str(ckpt_root / f"mp{mp}"), "--model_parallel_size",
                str(mp)]
        t0 = time.perf_counter()
        path = main(argv, tokenizer=cs._PieceTable(32000))
        outs[mp] = Path(path).read_text()
        print(f"[{card}] (a) eval_affordance.main --model_parallel_size "
              f"{mp} on the 2-layer checkpoint: {time.perf_counter() - t0:.1f}"
              " s")
    n = {mp: json.loads(o) for mp, o in outs.items()}
    for mp in (2, 4):
        same = sum(a["answer"] == b["answer"] for a, b in zip(n[mp], n[1]))
        if len(n[mp]) != len(n[1]) or [r["question"] for r in n[mp]] != [
                r["question"] for r in n[1]]:
            raise AssertionError(f"CLI at mp {mp}: records differ in order")
        print(f"[{card}] (a) CLI at mp {mp}: {same} of {len(n[1])} answers "
              "equal to one card's")


# ---------------------------------------------------------------- (b)


def run_b(card: str, task: str) -> None:
    """``ContinuousBatcher(mesh=)`` at mp 4 against one card."""
    from a3vlm_tpu_torch.config import Ens5Config
    from a3vlm_tpu_torch.eval_affordance import VQADataset
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.parallel.launch import run_spmd
    from a3vlm_tpu_torch.serving import partition_specs

    model = MetaModel("llama_ens5", with_visual=True, max_seq_len=2048,
                      dtype=torch.bfloat16, tokenizer=cs._PieceTable(32000),
                      model_cfg=Ens5Config(), seed=0, device="cuda:0")
    model.quantize(bits=4, tp_align=512)
    ds = VQADataset(task, input_size=448)
    alone = copy.copy(model)
    alone.tokenizer = cs._PieceTable(32000)
    one = cs._p14_cb_rank(None, alone, None, task)
    print(f"[{card}] (b) one card: run_eval_continuous "
          f"{one['wall_ms']:.1f} ms, steps {one['steps']}, ids digest "
          f"{cs.ids_digest(one['ids'])}")
    served = copy.copy(model)
    served.tokenizer = cs._PieceTable(32000)
    t0 = time.perf_counter()
    states = run_spmd(cs._p14_cb_rank, DEVICES, served,
                      partition_specs(model, 4), task,
                      model_parallel_size=4)
    print(f"[{card}] (b) ContinuousBatcher(mesh=) at mp 4: "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start; "
          f"run_eval_continuous {states[0]['wall_ms']:.1f} ms on rank 0, "
          f"steps {states[0]['steps']}")
    cs.p14_hold_ranks(card, "(b) mp 4", states, cs.CB_KERNELS)
    cs.p14_hold_ids(card, "(b) mp 4", states[0]["ids"], one["ids"],
                    "one card", lambda row, at: cs.cb_logit_gap(
                        model, ds[row], one["ids"][row], at))
    del model, served
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- (c)


def falcon_rank(mesh, layers: int, seed: int, row_parallel: bool):
    """This rank's Falcon at ``FalconArgs()`` widths with ``layers``
    layers, int4: the embeddings, head and each layer made on the rank's
    card, quantized, split by ``falcon_partition_specs`` and reduced to
    this rank's slice before the next layer is made. ``row_parallel``:
    wo and dense_4h_to_h chunk-packed in 4 (a chunk a rank), each layer
    from its own generator (seed, layer); otherwise chip_smoke's
    ``falcon_model`` weights (one generator through the layers in order,
    plain int4, every linear split by its output columns)."""
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import falcon
    from a3vlm_tpu_torch.parallel.mesh import shard_params
    from a3vlm_tpu_torch.quant import (quantize_params,
                                       quantized_partition_specs)

    mp = mesh.mp_size
    args = falcon.FalconArgs(num_layers=layers, vocab_size=cs.FALCON_VOCAB)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    top = falcon.init_falcon_params(
        dataclasses.replace(args, num_layers=0), torch.bfloat16, dev, gen)
    quantize_params(top, bits=4)
    specs = falcon.falcon_partition_specs(args)
    top_specs = quantized_partition_specs(
        {k: specs[k] for k in top if k != "layers"},
        {k: v for k, v in top.items() if k != "layers"}, mp)
    local = shard_params({k: v for k, v in top.items() if k != "layers"},
                         mesh, top_specs)
    del top
    one = dataclasses.replace(args, num_layers=1, vocab_size=8)
    local["layers"] = []
    qkw = dict(tp_align=128 * mp, row_parallel=mp) if row_parallel else {}
    for i in range(layers):
        if row_parallel:
            gen = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
        layer = {"layers": falcon.init_falcon_params(
            one, torch.bfloat16, dev, gen)["layers"]}
        quantize_params(layer, bits=4, **qkw)
        lspec = quantized_partition_specs({"layers": specs["layers"][:1]},
                                          layer, mp)
        local["layers"] += shard_params(layer, mesh, lspec)["layers"]
        del layer
    model = MetaModel("falcon", params=local, model_cfg=args,
                      tokenizer=cs._PieceTable(cs.FALCON_VOCAB), device=dev)
    model.mesh = mesh
    return model


def _falcon_serve(mesh, layers: int, seed: int, row_parallel: bool,
                  prompts, kv8_too: bool):
    """A rank of (c): make the rank's Falcon, then batch 4 and batch 1 (and
    with the int8 cache), 32 new ids each; ids, times, launches, profile."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = falcon_rank(mesh, layers, seed, row_parallel)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w2 = model.decoder["layers"][0]["mlp"]["dense_4h_to_h"]["weight"]
    out = {"rank": mesh.rank, "backend": mesh.backend, "build_s": build_s,
           "weights_gib": torch.cuda.memory_allocated() / 2**30,
           "w2": f"{getattr(w2, 'kind', 'whole')}"}
    model.generate_tokens(prompts, max_gen_len=2)  # warm-up
    runs = {}
    for kv8 in ((False, True) if kv8_too else (False,)):
        model.kv_cache_bits = 8 if kv8 else None
        for batch in ("B4", "B1"):
            ps = prompts if batch == "B4" else prompts[2:3]
            cs.reset_launches()
            qmm.reset_fallbacks()
            ids = model.generate_tokens(ps, max_gen_len=32, temperature=0.0)
            torch.cuda.synchronize()
            st = model.last_stats
            runs[("kv8 " if kv8 else "") + batch] = {
                "ids": ids, "prefill_ms": st["prefill_ms"],
                "step_ms": st["decode_ms"] / max(st["decode_steps"], 1),
                "launches": {n: cs.KERNELS[n][2].launches
                             for n in cs.KERNELS},
                "fallbacks": qmm.fallback_count()}
    model.kv_cache_bits = None
    out["runs"] = runs
    out["profile"] = step_profile(model, prompts, None)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def run_c(card: str) -> None:
    from a3vlm_tpu_torch.parallel.launch import run_spmd

    prompts = cs.seeded_prompts(20, cs.FALCON_VOCAB, cs.FALCON_PROMPTS)
    # the 16-layer cut: one card, then mp 4, the same weights
    model = cs.falcon_model()
    ref = {b: model.generate_tokens(ps, max_gen_len=32, temperature=0.0)
           for b, ps in (("B4", prompts), ("B1", prompts[2:3]))}
    print(f"[{card}] (c) falcon {cs.FALCON_LAYERS} layers on one card: ids "
          f"digest B4 {cs.ids_digest(ref['B4'])}, B1 "
          f"{cs.ids_digest(ref['B1'])}")
    states = run_spmd(_falcon_serve, DEVICES, cs.FALCON_LAYERS, 0, False,
                      prompts, False, model_parallel_size=4)
    report_falcon(card, f"(c) falcon {cs.FALCON_LAYERS} layers mp 4",
                  states)
    for b in ("B4", "B1"):
        ps = prompts if b == "B4" else prompts[2:3]
        got = states[0]["runs"][b]["ids"]
        for i, (g, w) in enumerate(zip(got, ref[b])):
            cs.fam_hold_ids(card, f"(c) falcon mp 4 {b} row {i}", model,
                            ps[i], {}, g, w, "one card")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the whole model
    states = run_spmd(_falcon_serve, DEVICES, 80, 7, True, prompts, True,
                      model_parallel_size=4)
    report_falcon(card, "(c) Falcon-180B 80 layers mp 4", states)


def report_falcon(card: str, label: str, states: list) -> None:
    for st in states:
        print(f"[{card}] {label}: rank {st['rank']} backend {st['backend']}"
              f", built in {st['build_s']:.1f} s, weights "
              f"{st['weights_gib']:.2f} GiB, peak {st['peak_gib']:.2f} GiB, "
              f"dense_4h_to_h {st['w2']}")
        for name, r in st["runs"].items():
            if st["rank"] == 0:
                print(f"[{card}] {label} {name}: prefill "
                      f"{r['prefill_ms']:.1f} ms, decode {r['step_ms']:.2f} "
                      f"ms a step (wall), lengths "
                      f"{[len(o) for o in r['ids']]}, ids digest "
                      f"{cs.ids_digest(r['ids'])}")
            launched = {n: c for n, c in r["launches"].items() if c}
            print(f"[{card}] {label} {name}: rank {st['rank']} launches "
                  f"{launched}, fallbacks {r['fallbacks']}")
            if r["fallbacks"]:
                raise AssertionError(f"{label} {name}: rank {st['rank']} "
                                     "took fallback routes")
            cs.require_counts(r["launches"], ("int4_matmul",
                                              "flash_attention"),
                              f"{label} {name}")
            if r["ids"] != states[0]["runs"][name]["ids"]:
                raise AssertionError(f"{label} {name}: rank {st['rank']}'s "
                                     "ids differ from rank 0's")
    print_profiles(card, label, [st["profile"] for st in states])


# the per-rank shapes of this slice's linears, int4 (K, N, chunks of a
# row-parallel tree or 0): the 13B at mp 2 and 4 (ffn 13824; its
# row-parallel tree pads the ffn to 14336) and Falcon-180B at mp 4
RANK_LINEARS = (
    (5120, 2560, 0), (5120, 6912, 0), (5120, 5120, 2), (14336, 5120, 2),
    (5120, 1280, 0), (5120, 3456, 0), (14336, 5120, 4), (5120, 16000, 0),
    (14848, 3712, 0), (14848, 128, 0), (14848, 14848, 0),
    (14848, 14848, 4), (59392, 14848, 4), (14848, 16256, 0),
)


# ---------------------------------------------------------------- (t)

T_STEPS = 4
T_FIRST_REL_TOL = cs.P15_FIRST_REL_TOL
T_LATER_REL_TOL = cs.P15_LATER_REL_TOL


def phase5_setup(device: str, mp: int):
    """chip_smoke's phase 5 on ``device``: the 13B built from seed 0, int4
    (packed for ``mp`` model ranks), rank-16 adapters, the mask, bf16 over
    float32 masters, and its batch, from the same generators."""
    from a3vlm_tpu_torch.config import Ens5Config
    from a3vlm_tpu_torch.main_finetune import qlora_trainable_mask
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import ens5
    from a3vlm_tpu_torch.train.lora import init_lora_params
    from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

    model = MetaModel("llama_ens5", with_visual=True, max_seq_len=2048,
                      dtype=torch.bfloat16, tokenizer=cs._PieceTable(32000),
                      model_cfg=Ens5Config(), seed=0, device=device)
    model.quantize(bits=4, tp_align=mp * 128 if mp > 1 else 0)
    gen = torch.Generator(device=device).manual_seed(17)
    lora = init_lora_params(gen, model.params["llama"], rank=16)
    mask = qlora_trainable_mask(model, lora, quant=True)
    model.params = mixed_precision_policy(model.params, mask, torch.bfloat16)
    mean = torch.tensor(ens5.CLIP_MEAN, device=device)
    std = torch.tensor(ens5.CLIP_STD, device=device)
    pixels = torch.rand(2, 448, 448, 3, generator=gen, device=device)
    text = 2048 - model.cfg.image_words
    examples = torch.randint(3, 32000, (2, text), generator=gen,
                             device=device)
    examples[:, 0] = 1
    labels = examples.clone()
    labels[:, :64] = 0
    batch = {"examples": examples, "labels": labels,
             "image": ((pixels - mean) / std).to(torch.bfloat16)}
    return model, lora, mask, batch


def train_steps(model, lora, mask, batch, mesh=None, restore=None,
                save=None):
    """``T_STEPS`` updates of the phase-5 step (on ``mesh``'s shard where
    given), then a save to ``save`` or, over the trained state, a restore
    of ``restore``. Returns each update's (loss, grad norm, ms) and, for
    ``restore``, how many restored leaves equal the files'."""
    from a3vlm_tpu_torch.checkpoint.bridge import params_from_host
    from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager
    from a3vlm_tpu_torch.main_finetune import (make_loss_fn,
                                               train_partition_specs)
    from a3vlm_tpu_torch.parallel.mesh import shard_params
    from a3vlm_tpu_torch.train.step import (TrainState, make_optimizer,
                                            make_train_step,
                                            partition_params)

    params = {**model.params, "lora": lora}
    if mesh is not None:
        params = shard_params(params, mesh, train_partition_specs(
            model, lora, mesh.mp_size))
        model.params = {k: v for k, v in params.items() if k != "lora"}
        model.mesh = mesh
    opt = make_optimizer(1e-3, max_grad_norm=8.0, weight_decay=0.0)
    step = make_train_step(make_loss_fn(model, torch.bfloat16, remat=True),
                           opt, accum_steps=1, trainable_mask=mask,
                           mesh=mesh)
    state = TrainState.create(params, opt, mask)
    out = {"steps": []}
    torch.cuda.synchronize()
    for _ in range(T_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out["steps"].append((loss, norm, (time.perf_counter() - t0) * 1e3))
    if save is not None:
        CheckpointManager(str(save), mesh=mesh).save(
            0, params=state.params, opt_state=state.opt_state,
            step=state.step, trainable_mask=mask)
    if restore is not None:
        mgr = CheckpointManager(restore.parent, mesh=mesh)
        state.params = mgr.restore_params(str(restore), state.params)
        state.opt_state = mgr.restore_train_state(
            str(restore), state.opt_state)["opt_state"]
        gathered = {"params": mgr._whole(partition_params(state.params,
                                                          mask)[0]),
                    "mu": mgr._whole(state.opt_state.mu),
                    "nu": mgr._whole(state.opt_state.nu)}
        if mesh is None or mesh.rank == 0:
            stored = params_from_host(torch.load(
                restore / "model.pt", weights_only=True), device=model.device)
            opt_file = torch.load(restore / "optimizer.pt",
                                  weights_only=True)
            n = cs._p15_same_leaves(gathered["params"], stored)
            for k in ("mu", "nu"):
                n += cs._p15_same_leaves(gathered[k], params_from_host(
                    opt_file[k], device=model.device))
            out["restored_leaves"] = n
    return out


def _train_rank(mesh, mp, save, restore):
    """A rank of (t): its model from the seeds on its card, the updates
    (or the restore) on ``mesh`` (``mp`` model ranks), its launches, its
    host time in the collectives and the NCCL kernels' device time."""
    model, lora, mask, batch = phase5_setup(str(mesh.device), mp)
    cs.reset_launches()
    qmm.reset_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = train_steps(model, lora, mask, batch, mesh, restore=restore,
                          save=save)
    nccl = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and any(c in e.key.lower() for c in COLLECTIVES)]
    out.update(rank=mesh.rank, launches=cs.launch_counts(),
               fallbacks=qmm.fallback_count(),
               collective_ms=cs._p15_collective_ms(prof),
               nccl_ms=sum(getattr(e, "self_device_time_total", 0.0)
                           for e in nccl) / 1e3,
               nccl_kernels=sum(e.count for e in nccl),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


def run_t(card: str, root: Path) -> None:
    """Phase 5's QLoRA step at data 2 x model 2 and 1 x 4 against one
    card; the 2 x 2 checkpoint restored at 1 x 4 after its updates."""
    from a3vlm_tpu_torch.parallel.launch import run_spmd

    t0 = time.perf_counter()
    model, lora, mask, batch = phase5_setup("cuda:0", 1)
    ref = train_steps(model, lora, mask, batch)
    del model, lora, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{card}] (t) one card: {time.perf_counter() - t0:.1f} s with "
          "the build; updates " + ", ".join(
              f"{ms:.1f} ms (loss {loss:.6f}, grad_norm {norm:.6f})"
              for loss, norm, ms in ref["steps"]))
    ckpt = root / "t_ckpt"
    for mp, save, restore in ((2, ckpt, None), (4, None, ckpt / "epoch_0")):
        label = f"(t) data {4 // mp} x model {mp}"
        t0 = time.perf_counter()
        outs = run_spmd(_train_rank, DEVICES, mp, save, restore,
                        model_parallel_size=mp)
        secs = time.perf_counter() - t0
        for o in outs:
            launched = {k: c for k, c in o["launches"].items() if c}
            print(f"[{card}] {label}: rank {o['rank']} updates "
                  + ", ".join(f"{ms:.1f}" for _, _, ms in o["steps"])
                  + f" ms, peak {o['peak_gib']:.2f} GiB, fallbacks "
                  f"{o['fallbacks']}, host in collectives "
                  f"{sum(o['collective_ms'].values()):.1f} ms "
                  f"({o['collective_ms']}), NCCL kernels "
                  f"{o['nccl_kernels']} for {o['nccl_ms']:.1f} ms of device "
                  f"time, launches {launched}")
            if o["fallbacks"]:
                raise AssertionError(f"{label}: rank {o['rank']} fell back")
        if restore is not None:
            print(f"[{card}] {label}: then the 2 x 2 save restored over "
                  f"its state: {outs[0]['restored_leaves']} leaves "
                  "(trainables, both moments) equal to the files "
                  "(torch.equal)")
        steps = outs[0]["steps"]
        wall = sum(ms for _, _, ms in steps)
        coll = sum(outs[0]["collective_ms"].values())
        print(f"[{card}] {label}: {secs:.1f} s with the ranks' start and "
              "builds; updates " + ", ".join(
                  f"{ms:.1f} ms (loss {loss:.6f}, grad_norm {norm:.6f})"
                  for loss, norm, ms in steps)
              + f"; rank 0's host in collectives {coll:.1f} ms "
              f"({coll / wall:.1%} of the updates' wall)")
        for o in outs:
            cs.require_counts(o["launches"], cs.P15_KERNELS,
                              f"{label} rank {o['rank']}")
        for i, (got, want) in enumerate(zip(steps, ref["steps"])):
            for j, what in ((0, "loss"), (1, "grad_norm")):
                rel = abs(got[j] - want[j]) / abs(want[j])
                tol = T_FIRST_REL_TOL if (i, j) == (0, 0) else \
                    T_LATER_REL_TOL
                print(f"[{card}] {label} update {i} {what}: "
                      f"{got[j]:.6f} vs one card {want[j]:.6f} (rel "
                      f"{rel:.3e}, limit {tol})")
                if rel > tol:
                    raise AssertionError(f"{label}: update {i} {what}")


def run_k(card: str) -> None:
    """The kernels at the per-rank shapes, on cuda:0, each against its
    plain version, timed as chip_smoke's phase 3 times its rows: K1 (a
    chunk of a row-parallel weight: the last rank's, group 32) at M 4 on
    a cold L2 and at M 1487 (one request's prefill, every rank's rows); K2
    at the 13B's 10 heads a rank and Falcon's 58 over 2; the decode kernel
    at the 13B's 10 kv heads a rank and Falcon's 2 (G 29, D 64)."""
    from a3vlm_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                  int4_matmul_2d,
                                                  int4_matmul_2d_plain)
    from a3vlm_tpu_torch.quant import _dequantize_leaf, _quantize_leaf_int4

    gen = torch.Generator(device="cuda").manual_seed(18)
    results = []
    with torch.inference_mode():
        for K, N, chunks in RANK_LINEARS:
            w = cs.random_weight(K, N, gen)
            qw = _quantize_leaf_int4(w, k_chunks=chunks or 1)
            if chunks:
                qw = qw.chunk(chunks - 1)
            del w
            copies = cs.weight_copies(qw)
            for M in (4, 1487):
                x = cs.randn(M, qw.in_dim, gen=gen)
                x2 = cs.padded(x, qw)
                got = int4_matmul(x, qw)
                err = cs.compare(f"int4 M={M} K={qw.in_dim} N={N}", got,
                                 int4_matmul(x, qw, impl="plain"))
                gemv = M <= qmm.GEMV_MAX_M
                cs.record(results, "int4_matmul",
                          f"M={M} K={qw.in_dim} N={N} g{qw.group}", err,
                          None if gemv else cs.timed_ms(
                              lambda: int4_matmul_2d(x2, qw.q, qw.scale,
                                                     qw.group), reps=3),
                          cs.timed_ms(lambda: int4_matmul_2d_plain(
                              x2, qw.q, qw.scale, qw.group), reps=1),
                          cs.int4_bytes(qw, M, got), 2 * M * qw.in_dim * N,
                          cs.timed_ms(lambda: x @ _dequantize_leaf(
                              qw, torch.bfloat16), reps=3))
                if gemv:
                    cs.time_cold(results[-1], lambda q, sc: int4_matmul_2d(
                        x2, q, sc, qw.group), copies)
            del copies, qw
            torch.cuda.empty_cache()
        # training at model 4: a rank's linears (M 2 x 2048) and heads
        for K, N in ((5120, 1280), (5120, 3456), (13824, 1280)):
            qw = _quantize_leaf_int4(cs.random_weight(K, N, gen))
            x = cs.randn(4096, K, gen=gen)
            x2 = cs.padded(x, qw)
            got = int4_matmul(x, qw)
            err = cs.compare(f"int4 mp4 train K={K} N={N}", got,
                             int4_matmul(x, qw, impl="plain"))
            cs.record(results, "int4_matmul",
                      f"M=4096 K={K} N={N} mp4 train", err,
                      cs.timed_ms(lambda: int4_matmul_2d(
                          x2, qw.q, qw.scale, qw.group), reps=3),
                      cs.timed_ms(lambda: int4_matmul_2d_plain(
                          x2, qw.q, qw.scale, qw.group), reps=3),
                      cs.int4_bytes(qw, 4096, got), 2 * 4096 * K * N,
                      cs.timed_ms(lambda: x @ _dequantize_leaf(
                          qw, torch.bfloat16), reps=3))
        cs.check_flash_bwd(gen, results, ((2, 10, 10, 2048, 2048),))
        cs.check_flash(gen, results, ((4, 10, 10, 1487, 1487),))
        cs.check_flash(gen, results, ((4, 58, 2, 32, 32),), D=64)
        cs.check_latency_kernels(gen, results, ((4, 10, 1, 1544),), ())
        cs.check_latency_kernels(gen, results, ((4, 2, 29, cs.FALCON_CACHE),
                                                (1, 2, 29, cs.FALCON_CACHE)),
                                 (), D=64)
    cs.print_rows(card, results)
    if cs.FAILURES:
        raise AssertionError("kernel checks failed:\n"
                             + "\n".join(cs.FAILURES))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="k,a,cli,b,c,t")
    phases = parser.parse_args(argv).phases.split(",")
    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"needs four cards; {torch.cuda.device_count()} "
                           "visible")
    card = cards()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.lib()
    print(f"[{card}] kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        task = cs.write_eval_tasks(root, card)
        failed = []
        for name, fn in (("k", lambda: run_k(card)),
                         ("a", lambda: run_a(card, task)),
                         ("cli", lambda: run_cli(card, task, root)),
                         ("b", lambda: run_b(card, task)),
                         ("c", lambda: run_c(card)),
                         ("t", lambda: run_t(card, root))):
            if name not in phases:
                continue
            t = time.perf_counter()
            try:
                fn()
            except Exception:  # the other phases still run; exit 1 below
                traceback.print_exc()
                failed.append(name)
            print(f"[{card}] ({name}): {time.perf_counter() - t:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[{card}] total {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"[{card}] failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
