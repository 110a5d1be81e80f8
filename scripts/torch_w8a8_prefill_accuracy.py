"""Numerics gate of the PyTorch port's W8A8 prefill mode
(``a3vlm_tpu_torch.ops.quant_matmul.W8A8_PREFILL``, K8 and its row
quantizer), counterpart of scripts/w8a8_prefill_accuracy.py.

One matmul's error is bounded by the kernel tests; this script measures
how the activations' int8 rounding and the weights' int8 requantization
compound through a full-depth PREFILL (the 7B's 32 layers, or with
``--shape 13b`` the 13B decoder of ``Ens5Config``), and how the perturbed
cache carries into the EXACT decode steps after it: the prefill writes the
rows every later token attends to. Both arms teacher-force the same ids;
the flag routes only M >= W8A8_PREFILL_MIN_M rows, so the decode steps run
the exact kernels in both arms and every difference comes from the
prefill.

The decoder is one of ``torch_w4a8_accuracy``'s two draws: by default
the JAX script's draw (``random_llama_int4``), the parity run with it,
which collapses the model onto one output up to a sign, so its figures
say little of the mode's accuracy at depth; with ``--draw depth_scaled``
``depth_scaled_llama`` (dense bf16 linears, quantized by the port's
``quantize_params``), whose dense tree runs as a third arm so that the
mode is held to ``noise_floor_rule`` on the prefill's last-position
logits and on the decode-through-cache logits.

Reports, for the prefill's last-position logits and for the logits of the
decode steps through the cache: relative RMS, max abs difference, the
exact logits' std and mean top-1/top-2 margin, greedy argmax agreement,
and each argmax disagreement with its top-1/top-2 gap against the step's
max abs difference (``torch_w4a8_accuracy.near_ties``); and on the
depth-scaled draw the rule's figures.

    python scripts/torch_w8a8_prefill_accuracy.py [--shape 7b|13b]
        [--draw jax|depth_scaled] [--prompt 512]
        [--steps 32] [--batch 2] [--seed 0] [--device cuda]

Prints one JSON line of the metrics; on the depth-scaled draw exits 1
when the mode fails the rule on either set of logits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from a3vlm_tpu_torch.models import llama  # noqa: E402
from a3vlm_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from scripts.torch_w4a8_accuracy import (  # noqa: E402
    SHAPES,
    brief,
    content_dependence,
    depth_scaled_llama,
    near_ties,
    noise_floor_rule,
    random_llama_int4,
    teacher_forced_ids,
)


def make_run(args, prompt_len: int, steps: int,
             cache_dtype: torch.dtype = torch.bfloat16):
    """The teacher-forced run (w8a8_prefill_accuracy.py:36-56):
    ``run(params, prompt, stream)`` returns the prefill's last-position
    logits [B, V] and every decode step's [steps, B, V], float32."""

    @torch.inference_mode()
    def run(params, prompt: torch.Tensor, stream: torch.Tensor):
        B = prompt.shape[0]
        cache = llama.KVCache.create(args, B, dtype=cache_dtype,
                                     device=prompt.device)
        pl_logits, cache, _ = llama.prefill(params, args, cache, prompt)
        out = torch.zeros((steps, B, args.vocab_size), dtype=torch.float32,
                          device=prompt.device)
        for i in range(steps):
            out[i], cache = llama.decode_step(params, args, cache,
                                              stream[:, i:i + 1],
                                              prompt_len + i)
        return pl_logits.float(), out

    return run


def metrics(exact: np.ndarray, got: np.ndarray) -> dict:
    """w8a8_prefill_accuracy.py:95-106's numbers of two logit arrays: the
    relative RMS over the whole array, max abs difference, the exact
    logits' std, their mean top-1/top-2 margin and greedy argmax
    agreement; ``near_ties`` and ``content_dependence``."""
    diff = got - exact
    rel = np.linalg.norm(diff) / np.linalg.norm(exact)
    agree = (got.argmax(-1) == exact.argmax(-1)).mean()
    srt = np.sort(exact, axis=-1)
    margin = (srt[..., -1] - srt[..., -2]).mean()
    return {
        "rel_rms": float(rel),
        "max_abs_diff": float(np.abs(diff).max()),
        "exact_std": float(exact.std()),
        "top2_margin_mean": float(margin),
        "argmax_agreement": float(agree),
        "disagreements": near_ties(exact, got),
        **content_dependence(exact),
    }


def run_arms(params, args, prompt: torch.Tensor, stream: torch.Tensor,
             run=None, dense=None) -> dict:
    """Both arms' (prefill, decode) logits as float32 numpy, with
    ``W8A8_PREFILL`` off (False) and on (True), and with ``dense`` (the
    dense tree of ``params``) a third arm ``"dense"``, run with the flag
    off; the flag is restored after. The prompt must reach the route's
    threshold (w8a8_prefill_accuracy.py:69), read at the call."""
    if prompt.shape[1] < qm.W8A8_PREFILL_MIN_M:
        raise ValueError(f"prompt {prompt.shape[1]} < W8A8_PREFILL_MIN_M "
                         f"{qm.W8A8_PREFILL_MIN_M}: the route would not "
                         "engage")
    run = run or make_run(args, prompt.shape[1], stream.shape[1])
    saved = qm.W8A8_PREFILL
    outs = {}
    try:
        for flag in (False, True):
            qm.W8A8_PREFILL = flag
            pf, dec = run(params, prompt, stream)
            outs[flag] = (pf.cpu().numpy(), dec.cpu().numpy())
        if dense is not None:
            qm.W8A8_PREFILL = False
            pf, dec = run(dense, prompt, stream)
            outs["dense"] = (pf.cpu().numpy(), dec.cpu().numpy())
    finally:
        qm.W8A8_PREFILL = saved
    return outs


LOGITS = ("prefill", "decode_through_cache")


def gate_metrics(outs: dict) -> dict:
    """``metrics`` of the prefill logits and of the decode-through-cache
    logits."""
    return {name: metrics(outs[False][i], outs[True][i])
            for i, name in enumerate(LOGITS)}


def rule_metrics(outs: dict) -> dict:
    """``noise_floor_rule`` on the prefill logits and on the
    decode-through-cache logits of ``run_arms``' three arms."""
    return {name: noise_floor_rule(outs["dense"][i], outs[False][i],
                                   outs[True][i])
            for i, name in enumerate(LOGITS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="7b")
    ap.add_argument("--draw", choices=("jax", "depth_scaled"),
                    default="jax")
    ap.add_argument("--prompt", type=int, default=512,
                    help=">= W8A8_PREFILL_MIN_M (256) so the route engages")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    margs = SHAPES[a.shape](max_batch_size=a.batch,
                            max_seq_len=a.prompt + a.steps + 8)
    prompt, stream = (torch.as_tensor(t, device=a.device) for t in
                      teacher_forced_ids(a.seed, a.batch, a.prompt, a.steps))
    print(f"building the {a.shape} ({a.draw} draw) on the device...",
          flush=True)
    if a.draw == "jax":
        params = random_llama_int4(margs, seed=a.seed, device=a.device)
        outs = run_arms(params, margs, prompt, stream)
        print(json.dumps({"w8a8_prefill": gate_metrics(outs)}))
        return 0
    dense, params = depth_scaled_llama(margs, a.seed, a.device)
    outs = run_arms(params, margs, prompt, stream, dense=dense)
    rule = rule_metrics(outs)
    print(json.dumps({
        "rule": {k: brief(v) for k, v in rule.items()},
        "w8a8_prefill": {k: brief(v) for k, v in gate_metrics(outs).items()},
        "pass": all(v["pass"] for v in rule.values())}))
    return 0 if all(v["pass"] for v in rule.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
