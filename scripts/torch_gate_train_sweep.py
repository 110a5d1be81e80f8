"""Training sweep for the closed-loop gate's model: how many epochs each
variant of the gate model takes to memorize the gate corpus
(scripts/torch_end_task_gate.py: the epoch's largest batch loss below
0.002), with no scoring.

    python scripts/torch_gate_train_sweep.py cuda card,d128h2_lr2e-3 [400]

Each variant is ``<model>[_f32][_lr<rate>][_s<seed>]``: ``<model>`` is
``card`` (``card_config``), ``tiny`` (``tiny_ens5_config``) or
``d<dim>h<heads>`` (``card_config`` with that decoder width and head
count); ``_f32`` trains in float32 (default: bf16 compute over float32
masters); ``_lr`` sets AdamW's rate (default: ``gate_lr``); ``_s`` the
weights' seed (default 0). Prints, per variant, the epochs, the final and
least epoch's largest batch loss, the seconds and that loss every 20
epochs.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from scripts import torch_end_task_gate as gate  # noqa: E402


def variant(name: str) -> dict:
    from a3vlm_tpu_torch.config import tiny_ens5_config

    head, *opts = name.split("_")
    card = gate.card_config()
    if head == "card":
        cfg = card
    elif head == "tiny":
        cfg = tiny_ens5_config()
    else:
        dim, heads = (int(v) for v in head[1:].split("h"))
        cfg = dataclasses.replace(card, llama=card.llama.replace(
            dim=dim, n_heads=heads, n_kv_heads=heads))
    out = {"cfg": cfg, "dtype": torch.bfloat16, "lr": None, "seed": 0}
    for o in opts:
        if o == "f32":
            out["dtype"] = torch.float32
        elif o.startswith("lr"):
            out["lr"] = float(o[2:])
        elif o.startswith("s"):
            out["seed"] = int(o[1:])
        else:
            raise ValueError(f"unknown option {o!r} in {name!r}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device, names = argv[0], argv[1].split(",")
    max_epochs = int(argv[2]) if len(argv) > 2 else 400
    with tempfile.TemporaryDirectory() as tmp:
        tok = gate.build_tokenizer(tmp)
        yaml_cfg = gate.write_data_yaml(tmp, gate.build_tasks(tmp))
        for name in names:
            v = variant(name)
            model = gate.gate_model(tok, device, cfg=v["cfg"],
                                    seed=v["seed"])
            out = gate.train_to_memorization(
                model, yaml_cfg, max_epochs, log=lambda line: None,
                compute_dtype=v["dtype"], lr=v["lr"])
            hist = out["history"]
            lr = gate.gate_lr(v["cfg"]) if v["lr"] is None else v["lr"]
            print(f"{name} (lr {lr:g}): epochs {len(hist)} final "
                  f"{hist[-1]:.5f} min {min(hist):.5f} "
                  f"{out['seconds']:.1f} s; every 20: "
                  + " ".join(f"{h:.3f}" for h in hist[::20]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
