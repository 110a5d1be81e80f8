"""Depth sweep of the depth-scaled draw of the PyTorch port's A8 numerics
gate (scripts/torch_w4a8_accuracy.py ``depth_scaled_llama``): the W4A8
gate (``depth_scaled_gate``: the exact, W4A8 and dense arms, the three
exact changes of rounding of ``control_arms``, ``fitness`` and
``noise_floor_rule``) at the 7B's widths and 1 to 32 layers, each depth
its own draw (seed 0, ``wo`` and ``w2`` x 1/sqrt(2 L) for that L), with
the W4A8 script's defaults (prompt 32, 64 forced steps, batch 4).

It tells two readings of an unfit draw apart: if the controls' error
against the exact arm grows with the depth, the stack amplifies a small
change of rounding (the draw is chaotic); if it stays flat, a kernel adds
an error of its own whatever the depth.

    python scripts/torch_depth_sweep.py [--device cuda]

Prints one JSON line a depth (the gate's figures, flips counted), then a
last line with each depth's controls' mean rel RMS and agreement against
the exact arm, ``e_int4`` and ``e_mode``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from scripts.torch_w4a8_accuracy import (  # noqa: E402
    brief,
    depth_scaled_gate,
    depth_scaled_llama,
    seven_b_args,
    teacher_forced_ids,
)

DEPTHS = (1, 2, 4, 8, 16, 32)
BATCH, PROMPT, STEPS = 4, 32, 64


def sweep(make_args, depths, prompt: torch.Tensor, stream: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16):
    """``depth_scaled_gate`` on the depth-scaled draw of
    ``make_args(n_layers)`` for each depth in ``depths``, made on
    ``prompt``'s device; yields each depth's gate with the flips
    counted, ``"n_layers"`` added. Each draw is freed before the next."""
    for n_layers in depths:
        args = make_args(n_layers)
        dense, params = depth_scaled_llama(args, 0, prompt.device,
                                           dtype=dtype)
        gate = depth_scaled_gate(dense, params, args, prompt, stream)
        del dense, params
        gc.collect()
        if prompt.is_cuda:
            torch.cuda.empty_cache()
        yield {"n_layers": n_layers,
               **{k: brief(v) if isinstance(v, dict)
                  and "disagreements" in v else v
                  for k, v in gate.items()}}


def summary(rows: list) -> dict:
    """Each depth's controls' mean rel RMS and agreement, ``e_int4`` and
    ``e_mode``, keyed by the number of layers."""
    return {r["n_layers"]: {
        **{name: [c["rel_rms_mean"], c["argmax_agreement"]]
           for name, c in r["fitness"]["controls"].items()},
        "distinct_argmax": r["fitness"]["distinct_argmax"],
        "e_int4": r["rule"]["e_int4"], "e_mode": r["rule"]["e_mode"]}
        for r in rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    prompt, stream = (torch.as_tensor(t, device=a.device) for t in
                      teacher_forced_ids(0, BATCH, PROMPT, STEPS))

    def make_args(n_layers):
        return seven_b_args(n_layers=n_layers, max_batch_size=BATCH,
                            max_seq_len=PROMPT + STEPS + 8)

    rows = []
    for row in sweep(make_args, DEPTHS, prompt, stream):
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"by_depth": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
