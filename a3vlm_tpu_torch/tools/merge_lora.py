"""Merge a trained LoRA adapter checkpoint of the port into dense base
weights and export a servable consolidated checkpoint (counterpart of
a3vlm_tpu/tools/merge_lora.py).

The adapter is a trainable-only train checkpoint of the port
(``main_finetune --lora_rank R --only_save_trainable``, optionally with
``--quant``): its dense trainables (norms, biases, projectors, image tags)
overlay the base and the rank-r adapters fold in as ``W + A @ B``. For
quantized serving, prefer ``eval_affordance --adapter_path``, which serves
the adapters unmerged on the packed base.

Usage:
  python -m a3vlm_tpu_torch.tools.merge_lora \\
      --base /ckpts/base --adapter /runs/qlora/epoch_2 \\
      --output_dir /ckpts/merged [--mp_size 2] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None, tokenizer=None):
    """``tokenizer``: an object with the tokenizer surface, in place of the
    one found beside ``--base`` or at ``--tokenizer_path``; it must have
    ``save(dir)``."""
    p = argparse.ArgumentParser("merge LoRA adapters into dense weights")
    p.add_argument("--base", nargs="+", required=True,
                   help="pretrained dir(s) for the dense base "
                   "(consolidated; diff ckpts apply in order)")
    p.add_argument("--adapter", required=True,
                   help="train checkpoint dir of the port "
                   "(only_save_trainable)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--llama_type", default=None)
    p.add_argument("--llama_config", nargs="*", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--with_visual", action="store_true",
                   help="build the full ens5 tree (towers exported too)")
    p.add_argument("--mp_size", type=int, default=1,
                   help="export TP shard count (consolidated.XX-of-YY)")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="merge precision (fp32 default: the fold W + A@B "
                   "should not round through bf16)")
    p.add_argument("--device", default="cuda",
                   help="torch device to merge on (cuda, or cpu)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from a3vlm_tpu_torch.checkpoint.bridge import params_to_numpy
    from a3vlm_tpu_torch.checkpoint.export import (
        ens5_params_to_consolidated,
        split_consolidated_shards,
    )
    from a3vlm_tpu_torch.meta import MetaModel

    model = MetaModel.from_pretrained(
        args.base,
        llama_type=args.llama_type,
        llama_config=args.llama_config,
        tokenizer_path=args.tokenizer_path,
        tokenizer=tokenizer,
        with_visual=args.with_visual,
        dtype=torch.float32 if args.dtype == "fp32" else torch.bfloat16,
        device=args.device,
    )
    model.load_adapter_checkpoint(args.adapter, merge=True)

    # the port serves llama_ens5 alone: the whole tree goes out, towers and
    # projectors included, in the reference's module naming
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sd = ens5_params_to_consolidated(params_to_numpy(model.params), model.cfg)
    shards = split_consolidated_shards(sd, args.mp_size)
    for rank, shard in enumerate(shards):
        torch.save(
            {"model": {
                k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in shard.items()
            }},
            out_dir / (
                f"consolidated.{rank:02d}-of-{args.mp_size:02d}"
                ".model.pth"
            ),
        )

    # self-describing sidecars so from_pretrained can probe the result
    with open(out_dir / "meta.json", "w") as f:
        json.dump({"llama_type": model.llama_type}, f)
    model.tokenizer.save(str(out_dir))
    print(f"merged checkpoint written to {out_dir}")
    return str(out_dir)


if __name__ == "__main__":
    main()
