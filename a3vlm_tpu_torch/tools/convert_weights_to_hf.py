"""Convert checkpoints to HuggingFace LLaMA format (reference
model/accessory/tools/convert_weights_to_hf.py): loads consolidated TP shards
(merging + optional base+delta stacks), maps to HF naming with the
interleaved->half-split rotary permutation, and writes a torch state dict
loadable by LlamaForCausalLM."""

from __future__ import annotations

import argparse
import json
import os


def convert(
    pretrained_paths: list[str],
    output_dir: str,
    n_layers: int,
    n_heads: int,
    n_kv_heads: int | None = None,
) -> str:
    import torch

    from a3vlm_tpu_torch.checkpoint.export import export_hf_llama
    from a3vlm_tpu_torch.checkpoint.torch_import import (
        apply_diff_checkpoint,
        import_llama_consolidated,
        load_consolidated_dir,
    )

    merged = None
    for p in pretrained_paths:
        sd, fmt = load_consolidated_dir(p)
        if fmt == "diff" and merged is not None:
            merged = apply_diff_checkpoint(merged, sd)
        else:
            merged = sd
    params = import_llama_consolidated(merged, n_layers=n_layers)
    hf_sd = export_hf_llama(params, n_heads=n_heads, n_kv_heads=n_kv_heads)

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "pytorch_model.bin")
    torch.save(
        {k: torch.from_numpy(v.copy()) for k, v in hf_sd.items()}, out_path
    )
    dim = hf_sd["model.norm.weight"].shape[0]
    vocab = hf_sd["model.embed_tokens.weight"].shape[0]
    config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": int(dim),
        "num_hidden_layers": n_layers,
        "num_attention_heads": n_heads,
        "num_key_value_heads": n_kv_heads or n_heads,
        "intermediate_size": int(
            hf_sd["model.layers.0.mlp.gate_proj.weight"].shape[0]
        ),
        "vocab_size": int(vocab),
        "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False,
    }
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser("consolidated -> HF LLaMA")
    p.add_argument("--pretrained_path", nargs="+", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--n_layers", type=int, required=True)
    p.add_argument("--n_heads", type=int, required=True)
    p.add_argument("--n_kv_heads", type=int, default=None)
    args = p.parse_args(argv)
    out = convert(
        args.pretrained_path, args.output_dir, args.n_layers, args.n_heads,
        args.n_kv_heads,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
