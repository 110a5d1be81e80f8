"""Extract/apply delta (diff) checkpoints per shard (reference
model/accessory/tools/weight_operate.py:17-58)."""

from __future__ import annotations

import argparse
import os


def operate(base_path: str, delta_path: str, output_path: str, op: str):
    import numpy as np
    import torch

    from a3vlm_tpu_torch.checkpoint.torch_import import (
        FORMAT_FILENAME_PATTERNS,
    )

    os.makedirs(output_path, exist_ok=True)
    pattern = FORMAT_FILENAME_PATTERNS["consolidated"]
    shards = sorted(f for f in os.listdir(base_path) if pattern.match(f))
    assert shards, f"no consolidated shards in {base_path}"
    for fn in shards:
        base = torch.load(
            os.path.join(base_path, fn), map_location="cpu", weights_only=True
        )
        other = torch.load(
            os.path.join(delta_path, fn.replace(".model.pth",
                                                ".model-diff.pth")
                         if op == "apply" else fn),
            map_location="cpu", weights_only=True,
        )
        base_sd = base.get("model", base)
        other_sd = other.get("model", other)
        out = {}
        for k, v in other_sd.items():
            if op == "extract":
                out[k] = v - base_sd[k] if k in base_sd else v
            else:  # apply
                out[k] = v + base_sd[k] if k in base_sd else v
        out_fn = (
            fn.replace(".model.pth", ".model-diff.pth")
            if op == "extract"
            else fn
        )
        torch.save({"model": out}, os.path.join(output_path, out_fn))
        print(f"wrote {out_fn}")


def main(argv=None):
    p = argparse.ArgumentParser("delta checkpoint extract/apply")
    p.add_argument("--base_path", required=True)
    p.add_argument("--delta_path", required=True,
                   help="finetuned ckpt (extract) or diff ckpt (apply)")
    p.add_argument("--output_path", required=True)
    p.add_argument("--operate_type", choices=["extract", "apply"],
                   required=True)
    args = p.parse_args(argv)
    operate(args.base_path, args.delta_path, args.output_path,
            args.operate_type)


if __name__ == "__main__":
    main()
