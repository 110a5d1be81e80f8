"""sentencepiece ``tokenizer.model`` -> HF fast-tokenizer dir, WITHOUT a
sentencepiece install.

Released LLaMA-2 / A3VLM checkpoints ship an spm ``tokenizer.model``
(reference model/accessory/model/tokenizer.py:24-44 loads it through the
sentencepiece C++ wheel, absent from this image). This converter makes
those artifacts loadable first-party:

- a minimal protobuf **wire-format** reader for sentencepiece's ModelProto
  (pieces + scores + types, trainer model_type, add_dummy_prefix) — the
  .model file is a plain proto; no generated bindings needed;
- an HF ``tokenizers`` construction mirroring transformers' SpmConverter:
  Unigram models map directly; BPE models get merges re-derived from the
  vocab by piece score (the LLaMA case, incl. byte-fallback pieces).

CLI: ``python -m a3vlm_tpu_torch.tools.spm_convert tokenizer.model out_dir``.
If sentencepiece *is* importable, ``--check`` encodes a probe corpus with
both backends and asserts identical ids.
"""

from __future__ import annotations

import argparse
import struct
from pathlib import Path

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
TYPE_UNIGRAM, TYPE_BPE, TYPE_WORD, TYPE_CHAR = 1, 2, 3, 4


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a proto message body."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover - groups are long-deprecated
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_model_proto(data: bytes) -> dict:
    """Minimal ModelProto reader: pieces [(piece, score, type)],
    model_type, add_dummy_prefix."""
    pieces = []
    model_type = TYPE_UNIGRAM
    add_dummy_prefix = True
    for field, wire, val in _fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _fields(val):
                if f2 == 3:  # model_type
                    model_type = v2
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _fields(val):
                if f2 == 6:  # add_dummy_prefix
                    add_dummy_prefix = bool(v2)
    return {
        "pieces": pieces,
        "model_type": model_type,
        "add_dummy_prefix": add_dummy_prefix,
    }


def _derive_bpe_merges(vocab: dict[str, int], scores: dict[str, float]):
    """Re-derive BPE merges from an spm vocab (transformers' SpmConverter
    algorithm): every piece splittable into two known pieces is a merge,
    ordered by the merged piece's score (higher = earlier)."""
    merges = []
    for merge, score in scores.items():
        if len(merge) < 2:
            continue
        local = []
        for idx in range(1, len(merge)):
            left, right = merge[:idx], merge[idx:]
            if left in vocab and right in vocab:
                local.append((left, right, score))
        local.sort(key=lambda x: (vocab[x[0]], vocab[x[1]]))
        merges.extend(local)
    merges.sort(key=lambda x: x[2], reverse=True)
    return [(a, b) for a, b, _ in merges]


def build_hf_tokenizer(parsed: dict):
    """ModelProto dict -> tokenizers.Tokenizer (LLaMA-style wiring)."""
    from tokenizers import Tokenizer, decoders, normalizers
    from tokenizers.models import BPE, Unigram

    pieces = parsed["pieces"]
    unk_id = next(
        (i for i, (_, _, t) in enumerate(pieces) if t == UNKNOWN), 0
    )
    has_byte_fallback = any(t == BYTE for _, _, t in pieces)

    if parsed["model_type"] == TYPE_BPE:
        vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
        scores = {
            p: s for p, s, t in pieces if t not in (CONTROL, UNKNOWN)
        }
        merges = _derive_bpe_merges(vocab, scores)
        tok = Tokenizer(
            BPE(
                vocab,
                merges,
                unk_token=pieces[unk_id][0],
                fuse_unk=True,
                byte_fallback=has_byte_fallback,
            )
        )
    else:
        tok = Tokenizer(
            Unigram(
                [(p, s) for p, s, _ in pieces],
                unk_id=unk_id,
                byte_fallback=has_byte_fallback,
            )
        )

    norms = [normalizers.Replace(" ", "▁")]
    if parsed["add_dummy_prefix"]:
        norms.insert(0, normalizers.Prepend("▁"))
    tok.normalizer = normalizers.Sequence(norms)
    decs = [decoders.Replace("▁", " ")]
    if has_byte_fallback:
        decs.append(decoders.ByteFallback())
    decs.append(decoders.Fuse())
    if parsed["add_dummy_prefix"]:
        decs.append(decoders.Strip(" ", 1, 0))
    tok.decoder = decoders.Sequence(decs)
    return tok


def convert(model_path: str, out_dir: str) -> str:
    """Convert ``tokenizer.model`` to an HF fast-tokenizer directory;
    returns out_dir. Control pieces 0/1/2 follow the LLaMA convention
    (<unk>/<s>/</s>) unless other CONTROL pieces say otherwise."""
    from transformers import PreTrainedTokenizerFast

    data = Path(model_path).read_bytes()
    parsed = parse_model_proto(data)
    tok = build_hf_tokenizer(parsed)
    pieces = parsed["pieces"]

    def piece_or(idx, default):
        return pieces[idx][0] if idx < len(pieces) else default

    unk_id = next(
        (i for i, (_, _, t) in enumerate(pieces) if t == UNKNOWN), 0
    )
    controls = [i for i, (_, _, t) in enumerate(pieces) if t == CONTROL]
    bos_id = controls[0] if controls else 1
    eos_id = controls[1] if len(controls) > 1 else 2
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok,
        unk_token=piece_or(unk_id, "<unk>"),
        bos_token=piece_or(bos_id, "<s>"),
        eos_token=piece_or(eos_id, "</s>"),
    )
    fast.save_pretrained(out_dir)
    return out_dir


def check_equivalence(model_path: str, hf_dir: str, corpus=None) -> None:
    """If sentencepiece is importable, assert both backends agree on a probe
    corpus; otherwise skip silently (env without spm)."""
    try:
        from sentencepiece import SentencePieceProcessor
    except ImportError:  # pragma: no cover - spm absent in this image
        print("sentencepiece not importable; equivalence check skipped")
        return
    from transformers import AutoTokenizer

    sp = SentencePieceProcessor(model_file=model_path)
    hf = AutoTokenizer.from_pretrained(hf_dir)
    corpus = corpus or [
        "Hi my darling",
        "### Human: What is the joint's type?",
        "[0.12,0.34,0.56,0.78,0.90]",
        "detect all manipulable object parts",
    ]
    for s in corpus:
        a = sp.encode(s)
        b = hf.encode(s, add_special_tokens=False)
        assert a == b, (s, a, b)
    print(f"equivalence OK on {len(corpus)} probes")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help="path to sentencepiece tokenizer.model")
    ap.add_argument("out_dir", help="output HF tokenizer directory")
    ap.add_argument("--check", action="store_true",
                    help="verify vs sentencepiece if importable")
    args = ap.parse_args(argv)
    convert(args.model, args.out_dir)
    print(f"wrote HF tokenizer to {args.out_dir}")
    if args.check:
        check_equivalence(args.model, args.out_dir)


if __name__ == "__main__":
    main()
