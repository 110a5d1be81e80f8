"""Offline data-format converters (reference tools/llava_to_single_turn.py
and tools/data_conversion/to_alpaca/gorilla.py)."""

from __future__ import annotations

import argparse
import json


def llava_to_single_turn(records: list[dict]) -> list[dict]:
    """Multi-turn llava conversations -> one single-turn record per
    human/gpt pair (tools/llava_to_single_turn.py)."""
    out = []
    for rec in records:
        conv = rec["conversations"]
        for i in range(0, len(conv) - 1, 2):
            if conv[i]["from"] != "human" or conv[i + 1]["from"] != "gpt":
                continue
            item = {
                "instruction": conv[i]["value"].replace("<image>", "").strip(),
                "input": "",
                "output": conv[i + 1]["value"],
            }
            if "image" in rec:
                item["image"] = rec["image"]
            out.append(item)
    return out


def gorilla_to_alpaca(records: list[dict]) -> list[dict]:
    """Gorilla API-call records -> alpaca format
    (tools/data_conversion/to_alpaca/gorilla.py)."""
    out = []
    for rec in records:
        code = rec.get("code", "")
        instruction = rec.get("api_call", "")
        if isinstance(rec.get("code"), str) and "###Instruction" in code:
            # gorilla embeds the instruction inside the code field
            seg = code.split("###Instruction:", 1)[1]
            instruction = seg.split("###", 1)[0].strip()
        out.append(
            {
                "instruction": instruction,
                "input": "",
                "output": rec.get("api_call", rec.get("output", "")),
            }
        )
    return out


def main(argv=None):
    p = argparse.ArgumentParser("dataset format conversion")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--recipe", choices=["llava_to_single_turn",
                                        "gorilla_to_alpaca"], required=True)
    args = p.parse_args(argv)
    with open(args.input) as f:
        records = json.load(f)
    fn = {"llava_to_single_turn": llava_to_single_turn,
          "gorilla_to_alpaca": gorilla_to_alpaca}[args.recipe]
    out = fn(records)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out)} records to {args.output}")


if __name__ == "__main__":
    main()
