"""Pack tokenized text into fixed-length rows for pretraining (reference
model/accessory/tools/generate_packed_data.py:14-50): tokenize each document
with bos+eos, concatenate, and cut into fixed 2048-token blocks saved as
pickled lists."""

from __future__ import annotations

import argparse
import json
import os
import pickle


def pack_file(input_path: str, output_path: str, tokenizer, block_size: int):
    buffer: list[int] = []
    blocks: list[list[int]] = []
    with open(input_path) as f:
        if input_path.endswith(".jsonl"):
            texts = (json.loads(line).get("content") or
                     json.loads(line).get("text", "") for line in f)
        else:
            texts = (line.rstrip("\n") for line in f)
        for text in texts:
            if not text:
                continue
            buffer += tokenizer.encode(text, bos=True, eos=True)
            while len(buffer) >= block_size:
                blocks.append(buffer[:block_size])
                buffer = buffer[block_size:]
    with open(output_path, "wb") as f:
        pickle.dump(blocks, f)
    return len(blocks)


def main(argv=None):
    from a3vlm_tpu_torch.tokenizer import Tokenizer

    p = argparse.ArgumentParser("pack text into fixed token blocks")
    p.add_argument("--input", nargs="+", required=True,
                   help=".txt or .jsonl (content/text field) files")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--tokenizer_path", required=True)
    p.add_argument("--block_size", type=int, default=2048)
    args = p.parse_args(argv)

    tok = Tokenizer(args.tokenizer_path)
    os.makedirs(args.output_dir, exist_ok=True)
    for path in args.input:
        base = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_dir, f"{base}_packed.pkl")
        n = pack_file(path, out, tok, args.block_size)
        print(f"{path}: {n} blocks -> {out}")


if __name__ == "__main__":
    main()
