"""Inference/eval CLI of the port (counterpart of
a3vlm_tpu/eval_affordance.py; the A3VLM "serve", reference
model/accessory/eval_affordance_v2.py): a task JSON goes in, a results JSON
of {answer, format_answer, annotation, question, image, fail} records comes
out.

    python -m a3vlm_tpu_torch.eval_affordance --pretrained_path CKPT \\
        --dataset tasks.json --quant [--device cuda]

One process drives one device: ``--device`` (default ``cuda``) takes the
place of the JAX CLI's ``JAX_PLATFORMS``, and the CLI never falls back to
the CPU by itself. The flags and their defaults are the JAX CLI's. The
quantized-matmul flags set the port's mode switches
(``ops.quant_matmul.W4A8_DECODE``, ``W8A8_PREFILL``);
``--continuous_batching`` serves the task file through the slot pool
(``run_eval_continuous``); the flags of parts not ported yet raise
``NotImplementedError`` naming their ROADMAP item.

Behaviour carried over from the reference:
- VQADataset over task JSON with sampling cap and resume-by-results-file
  dedup (:109-180, :121-130); ``.npy`` point-cloud items rendered to an
  image;
- PadToSquare + resize transform (:97-105);
- conversation-wrapped prompts (:159-161);
- answer post-processing: '###' split, "answer is" extraction,
  ``format_bounding_box`` repair, failure flagging (:344-372);
- merged JSON dump of the records (:386-401).
"""

from __future__ import annotations

import argparse
import json
import os
import random
from pathlib import Path

import numpy as np

from a3vlm_tpu_torch.codecs.repair import (
    check_box_failed,
    extract_answer,
    format_bounding_box,
)
from a3vlm_tpu_torch.data.conversation import conv_templates


class VQADataset:
    """(eval_affordance_v2.py:109-180)"""

    def __init__(
        self,
        task_json: str,
        input_size: int = 448,
        max_samples: int | None = None,
        existing_results: list | None = None,
        seed: int = 0,
    ):
        with open(task_json) as f:
            data = json.load(f)
        if max_samples is not None and len(data) > max_samples:
            random.seed(seed)
            data = random.sample(data, max_samples)
        if existing_results:
            done = {
                (r["image"], r["question"]) for r in existing_results
            }
            data = [
                d
                for d in data
                if (d["image"], _question_of(d)) not in done
            ]
        self.data = data
        self.input_size = input_size

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        item = self.data[idx]
        question = _question_of(item)
        annotation = item["conversations"][1]["value"] if len(
            item["conversations"]
        ) > 1 else ""
        path = item["image"]
        try:
            if path.endswith(".npy"):
                # point-cloud item (eval_affordance_with_quant.py:174-189):
                # project the cloud to a simple depth-colored image so the
                # image-conditioned models can consume it
                image = self._render_point_cloud(path)
            else:
                from PIL import Image

                from a3vlm_tpu_torch.data.transforms import padded_resize

                img = Image.open(path).convert("RGB")
                image = padded_resize(img, self.input_size)
        except Exception:
            # corrupt-image resampling (:146-155)
            return self[(idx + 1) % len(self)]

        conv = conv_templates["v1"]()
        conv.load_qas([[question, None]])
        prompt = conv.get_prompt()
        return {
            "image": image.astype(np.float32),
            "prompt": prompt,
            "question": question,
            "annotation": annotation,
            "image_path": item["image"],
        }

    def _render_point_cloud(self, path: str) -> np.ndarray:
        from a3vlm_tpu_torch.data.transforms import (
            CLIP_MEAN,
            CLIP_STD,
            load_objaverse_point_cloud,
        )

        # reference loader semantics (raw coordinates, rgb in [0,1]);
        # center/scale xyz locally just for the 2-D projection
        pc = load_objaverse_point_cloud(path)
        xyz = pc[:, :3] - pc[:, :3].mean(axis=0)
        m = np.max(np.sqrt(np.sum(xyz**2, axis=1)))
        xyz = xyz / (m + 1e-8)
        s = self.input_size
        img = np.zeros((s, s, 3), np.float32)
        xy = ((xyz[:, :2] * 0.5 + 0.5) * (s - 1)).astype(int)
        colors = (
            pc[:, 3:6] if pc.shape[1] >= 6
            else np.tile((xyz[:, 2:3] * 0.5 + 0.5), (1, 3))
        )
        img[xy[:, 1], xy[:, 0]] = np.clip(colors, 0, 1)
        return (img - CLIP_MEAN) / CLIP_STD


def _question_of(item):
    q = item["conversations"][0]["value"]
    return q.replace("<image>", "").strip()


def run_eval(
    model,
    dataset: VQADataset,
    batch_size: int = 4,
    max_gen_len: int = 2048,
    temperature: float = 0.1,
    top_p: float = 0.75,
    fsm=None,
    draft_k: int = 0,
) -> list[dict]:
    """Batches of ``batch_size`` items through ``model.generate`` with the
    conversation's end signal as a stop symbol (eval_affordance.py:133).
    ``fsm``: a ``constrained.TokenFsm`` that grammar-masks every generated
    token so answers always parse; ``--constrained`` routes the task file
    name through ``constrained.fsm_for_task``."""
    outputs = []
    conv_sep = conv_templates["v1"]().response_end_signal
    for start in range(0, len(dataset), batch_size):
        items = [
            dataset[i]
            for i in range(start, min(start + batch_size, len(dataset)))
        ]
        images = np.stack([it["image"] for it in items])
        prompts = [it["prompt"] for it in items]
        results = model.generate(
            prompts,
            images=images,
            max_gen_len=max_gen_len,
            temperature=temperature,
            top_p=top_p,
            additional_stop_symbols=[conv_sep],
            fsm=fsm,
            draft_k=draft_k,
        )
        for it, raw in zip(items, results):
            answer = extract_answer(raw)
            dt_bbox = format_bounding_box(answer)
            failed = check_box_failed(dt_bbox)
            outputs.append(
                {
                    "answer": answer,
                    "format_answer": dt_bbox,
                    "annotation": it["annotation"],
                    "question": it["question"],
                    "image": it["image_path"],
                    "fail": failed,
                }
            )
    return outputs


def run_eval_continuous(
    model,
    dataset: VQADataset,
    batch_size: int = 4,
    max_gen_len: int = 2048,
    temperature: float = 0.1,
    top_p: float = 0.75,
    draft_k: int = 0,
    fsm=None,
) -> list[dict]:
    """Continuous-batching eval (eval_affordance.py:183): the items are
    grouped by the image each one actually loaded, each image's [BOS |
    image words] KV prefix is computed once (``make_prefix``) and every
    question about it admits as a text-only extension into a pool of
    ``batch_size`` slots (``serving_batch.ContinuousBatcher``). The task
    files ask about 12 questions per object render. Same records as
    ``run_eval``; ``fsm`` grammar-constrains every slot's tokens."""
    from a3vlm_tpu_torch.serving_batch import ContinuousBatcher

    cb = ContinuousBatcher(
        model._decoder_params(),
        model.args,
        model.tokenizer,
        slots=batch_size,
        kv_cache_bits=model.kv_cache_bits,
        ens5_params=model.params,
        ens5_cfg=model.cfg,
        vocab_limit=model.true_vocab,
        draft_k=draft_k,
        fsm=fsm,
        device=model.device,
    )
    # every admission here extends a [BOS | image words] prefix with a
    # question, which lands in the small buckets
    cb.warmup(
        buckets=(16, 32, 64, 128),
        prefix_len=1 + model.cfg.image_words,
        temperature=temperature, top_p=top_p,
    )
    # group the MATERIALIZED items by their image path: VQADataset
    # substitutes the next item for a corrupt image, so a resampled item
    # must decode against the render it actually loaded
    groups: dict[str, list[dict]] = {}
    for i in range(len(dataset)):
        it = dataset[i]
        groups.setdefault(it["image_path"], []).append(it)

    outputs = []
    agg = {"tokens": 0, "total_s": 0.0, "tpots": [], "ttfts": []}
    for items in groups.values():
        prefix = cb.make_prefix(image=np.asarray(items[0]["image"]))
        results = cb.generate(
            [it["prompt"] for it in items],
            max_gen_len=max_gen_len,
            temperature=temperature,
            top_p=top_p,
            prefixes=[prefix] * len(items),
            additional_stop_symbols=[
                conv_templates["v1"]().response_end_signal
            ],
        )
        del prefix  # one image's KV prefix at a time
        s = cb.last_stats
        if s and s.get("requests"):
            agg["tokens"] += s["tokens"]
            agg["total_s"] += s["total_s"]
            agg["tpots"] += [p["tpot_ms"] for p in s["per_request"]
                             if p["tokens"] > 1]
            agg["ttfts"] += [p["ttft_s"] for p in s["per_request"]]
        for it, raw in zip(items, results):
            answer = extract_answer(raw)
            dt_bbox = format_bounding_box(answer)
            outputs.append(
                {
                    "answer": answer,
                    "format_answer": dt_bbox,
                    "annotation": it["annotation"],
                    "question": it["question"],
                    "image": it["image_path"],
                    "fail": check_box_failed(dt_bbox),
                }
            )
    if agg["ttfts"]:
        def pct(v, q):
            v = sorted(v)
            return v[min(int(q * (len(v) - 1) + 0.5), len(v) - 1)]

        tp = agg["tpots"] or [0.0]
        print(
            f"serving: {agg['tokens']} tokens in {agg['total_s']:.1f}s "
            f"({agg['tokens'] / max(agg['total_s'], 1e-9):.1f} tok/s), "
            f"ttft p50/p95 {pct(agg['ttfts'], .5):.3f}/"
            f"{pct(agg['ttfts'], .95):.3f} s, "
            f"tpot p50/p95 {pct(tp, .5):.1f}/{pct(tp, .95):.1f} ms"
        )
    return outputs


def get_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("A3VLM affordance eval (PyTorch)")
    parser.add_argument("--pretrained_path", nargs="+", default=None)
    parser.add_argument("--llama_type", default="llama_ens5")
    parser.add_argument("--llama_config", nargs="*", default=None)
    parser.add_argument("--tokenizer_path", default=None)
    parser.add_argument("--dataset", required=True, help="task JSON path")
    parser.add_argument("--output_dir", default="./eval_out")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--input_size", type=int, default=448)
    parser.add_argument("--max_seq_len", type=int, default=4096)
    parser.add_argument("--max_gen_len", type=int, default=2048)
    parser.add_argument("--temperature", type=float, default=0.1)
    parser.add_argument("--top_p", type=float, default=0.75)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--quant", action="store_true",
                        help="int4 weight-only quantized decoder (the "
                        "eval_affordance_with_quant.py:327-342 path)")
    parser.add_argument("--quant_bits", type=int, default=4, choices=[4, 8])
    parser.add_argument("--adapter_path", default=None,
                        help="a trainable-only train checkpoint of the "
                        "port (main_finetune --only_save_trainable): its "
                        "dense trainables overlay the model and its LoRA "
                        "adapters are served unmerged")
    parser.add_argument("--w4a8", action="store_true",
                        help="int8-activation decode matmuls on the int4 "
                        "base (ops/quant_matmul.W4A8_DECODE). NOT "
                        "bit-exact: activations round to per-row int8. "
                        "Requires --quant with --quant_bits 4")
    parser.add_argument("--w8a8_prefill", action="store_true",
                        help="int8-activation prefill matmuls on the int4 "
                        "base (ops/quant_matmul.W8A8_PREFILL): the weights "
                        "requantized to int8 per tile. NOT bit-exact. "
                        "Requires --quant with --quant_bits 4")
    parser.add_argument("--tower_bits", type=int, default=None, choices=[8],
                        help="W8A8 int8 vision towers (per-channel weights, "
                        "per-row activations). Opt-in serving mode beyond "
                        "the reference; NOT bit-exact")
    parser.add_argument("--kv_cache_bits", type=int, default=None,
                        choices=[8],
                        help="int8 KV cache (half the decode cache bytes; "
                        "ops/decode_attention.py)")
    parser.add_argument("--dataset_registry", default=None,
                        help="JSON of {name: task_json_path} (the "
                        "ds_collections registry, "
                        "eval_affordance_with_quant.py:58-72); --dataset "
                        "then names an entry")
    parser.add_argument("--tiny_random_model", action="store_true",
                        help="use a tiny random-weight model (smoke/demo)")
    parser.add_argument("--score", action="store_true",
                        help="print paper-style metrics for the results "
                        "file (tools/score_results.py)")
    parser.add_argument("--constrained", action="store_true",
                        help="grammar-constrained decoding: mask every "
                        "generated token to the task's answer grammar "
                        "(constrained.fsm_for_task routes by task file "
                        "name; malformed triads become impossible, EOS "
                        "only at grammar-complete answers)")
    parser.add_argument("--continuous_batching", action="store_true",
                        help="slot-pool serving with per-image KV-prefix "
                        "reuse (serving_batch.py): the questions about one "
                        "render share its 1456-token prefix")
    parser.add_argument("--draft_k", type=int, default=0,
                        help="prompt-lookup speculative decoding: verify K "
                        "drafted tokens per round. With "
                        "--continuous_batching it speculates per slot "
                        "(serving_batch.py; greedy only: requires "
                        "--temperature 0); without, batch_size 1 routes "
                        "through the lookup loop (lookup_decode.py), whose "
                        "output equals the vanilla loop's, greedy or "
                        "sampled")
    parser.add_argument("--model_parallel_size", type=int, default=1,
                        help="only 1: one device (more is ROADMAP Queue 1 "
                        "item 17)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the model runs on (cuda, or cpu "
                        "for tests); the counterpart of JAX_PLATFORMS")
    return parser


def _refuse_unported(args) -> None:
    unported = [
        (args.model_parallel_size > 1, "--model_parallel_size > 1",
         "Queue 1 item 17 (several devices)"),
        (args.llama_type != "llama_ens5", f"llama_type {args.llama_type}",
         "Queue 1 item 15 (the other model families)"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                      f"{item})")


def main(argv=None, tokenizer=None):
    """The CLI (eval_affordance.py:286). ``tokenizer``: an object with the
    tokenizer surface to use in place of ``--tokenizer_path`` or the
    checkpoint's own (the text tokenizer needs ``transformers``, or
    ``sentencepiece`` for a ``.model`` file). Returns the results file."""
    parser = get_args_parser()
    args = parser.parse_args(argv)
    _refuse_unported(args)
    if args.draft_k and args.temperature != 0.0 and args.continuous_batching:
        # the slot pool's speculative verify is greedy only; the batch-1
        # lookup loop samples as the vanilla loop does
        parser.error("--continuous_batching --draft_k is greedy-only: "
                     "pass --temperature 0")

    import torch

    from a3vlm_tpu_torch.ops import quant_matmul as qmm

    # the mode switches are module globals, read at every call; as in the
    # JAX CLI a flag sets its switch and nothing clears it
    if args.w4a8:
        if not (args.quant and args.quant_bits == 4):
            parser.error("--w4a8 requires --quant --quant_bits 4")
        qmm.W4A8_DECODE = True
    if args.w8a8_prefill:
        if not (args.quant and args.quant_bits == 4):
            parser.error("--w8a8_prefill requires --quant --quant_bits 4")
        qmm.W8A8_PREFILL = True

    if args.dataset_registry:
        with open(args.dataset_registry) as f:
            registry = json.load(f)
        if args.dataset in registry:
            args.dataset = registry[args.dataset]

    from a3vlm_tpu_torch.meta import MetaModel

    device = torch.device(args.device)
    if args.tiny_random_model:
        from a3vlm_tpu_torch.config import tiny_ens5_config

        cfg = tiny_ens5_config()
        model = MetaModel(
            llama_type="llama_ens5",
            tokenizer_path=args.tokenizer_path,
            tokenizer=tokenizer,
            with_visual=True,
            max_seq_len=args.max_seq_len,
            model_cfg=cfg,
            device=device,
        )
        input_size = cfg.image_size
    else:
        if not args.pretrained_path:
            parser.error("pass --pretrained_path or --tiny_random_model")
        model = MetaModel.from_pretrained(
            args.pretrained_path,
            llama_type=args.llama_type,
            llama_config=args.llama_config,
            tokenizer_path=args.tokenizer_path,
            tokenizer=tokenizer,
            with_visual=True,
            max_seq_len=args.max_seq_len,
            device=device,
        )
        input_size = args.input_size

    if args.quant or args.tower_bits:
        model.quantize(
            bits=args.quant_bits if args.quant else None,
            tower_bits=args.tower_bits,
        )
    if args.adapter_path:
        # after quantize(), which drops attached adapters
        model.load_adapter_checkpoint(args.adapter_path)
    if args.kv_cache_bits:
        model.kv_cache_bits = args.kv_cache_bits

    os.makedirs(args.output_dir, exist_ok=True)
    results_file = str(
        Path(args.output_dir)
        / f"results_{Path(args.dataset).stem}.json"
    )
    existing = None
    if os.path.exists(results_file):
        with open(results_file) as f:
            existing = json.load(f)
        print(f"resuming: {len(existing)} results already present")

    dataset = VQADataset(
        args.dataset,
        input_size=input_size,
        max_samples=args.max_samples,
        existing_results=existing,
    )
    print(f"evaluating {len(dataset)} samples")
    fsm = None
    if args.constrained:
        from a3vlm_tpu_torch.constrained import fsm_for_task

        fsm = fsm_for_task(Path(args.dataset).stem, model.tokenizer)
        print(
            f"constrained decoding: "
            f"{'grammar FSM with %d states' % fsm.n_states if fsm else 'no grammar family matches this task; running unconstrained'}"
        )
    run = run_eval_continuous if args.continuous_batching else run_eval
    outputs = run(
        model,
        dataset,
        batch_size=args.batch_size,
        max_gen_len=args.max_gen_len,
        temperature=args.temperature,
        top_p=args.top_p,
        fsm=fsm,
        draft_k=args.draft_k,
    )
    if existing:
        outputs.extend(existing)
    with open(results_file, "w") as f:
        json.dump(outputs, f, ensure_ascii=False)
    print(f"wrote {len(outputs)} results to {results_file}")
    if args.score:
        from a3vlm_tpu_torch.tools.score_results import main as score_main

        score_main([results_file])
    return results_file


if __name__ == "__main__":
    main()
