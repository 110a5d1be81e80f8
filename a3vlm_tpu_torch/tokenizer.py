"""Tokenizer with the reference's dual-backend API and segment-encoding
semantics (model/accessory/model/tokenizer.py).

Backends:
- HuggingFace ``tokenizers``/``transformers`` directory (tokenizer.json) —
  the primary backend (sentencepiece's Python wheel is not in this image;
  HF tokenizers covers LLaMA's SPM vocab via tokenizer.json).
- A ``.model`` sentencepiece path: used directly when the optional
  sentencepiece package is importable; otherwise AUTO-CONVERTED to an HF
  fast tokenizer next to the file via ``tools/spm_convert.py`` (first-party
  ModelProto parser — no spm install needed).

Key behavioral contracts carried over:
- ``_probe_tokenizer_style`` (tokenizer.py:90-112): detect whether a leading
  space must be added when encoding a segment cut from a longer text.
- ``encode_segment`` / ``encode_wo_prefix_space`` (tokenizer.py:64-88) —
  critical for exact label alignment in dialog training and for stop-symbol
  token matching in generation.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List


class Tokenizer:
    def __init__(self, model_path: str):
        if model_path.endswith(".model"):
            try:
                from sentencepiece import SentencePieceProcessor
            except ImportError:
                # first-party ingestion path: convert the spm proto to an
                # HF fast tokenizer (tools/spm_convert.py) and load that —
                # released LLaMA-2/A3VLM checkpoints ship tokenizer.model
                # and sentencepiece's wheel is absent from this image
                model_path = self._convert_spm(model_path)
            else:
                self.tokenizer_type = "spm"
                assert os.path.isfile(model_path), model_path
                self.tokenizer = SentencePieceProcessor(model_file=model_path)
                self.bos_id: int = self.tokenizer.bos_id()
                self.eos_id: int = self.tokenizer.eos_id()
        if not model_path.endswith(".model"):
            from transformers import AutoTokenizer

            self.tokenizer_type = "transformers"
            self.tokenizer = AutoTokenizer.from_pretrained(
                model_path, trust_remote_code=True
            )
            self.bos_id = self.tokenizer.bos_token_id
            if self.bos_id is None:
                self.bos_id = self.tokenizer.eos_token_id
            self.eos_id = self.tokenizer.eos_token_id
            assert self.eos_id is not None

        self._probe_tokenizer_style()

    @staticmethod
    def _convert_spm(model_path: str) -> str:
        """Convert tokenizer.model next to itself (cached) and return the
        HF dir."""
        from a3vlm_tpu_torch.tools.spm_convert import convert

        out_dir = str(Path(model_path).with_suffix("")) + "_hf"
        if not (Path(out_dir) / "tokenizer.json").exists():
            convert(model_path, out_dir)
        return out_dir

    # -- encoding ----------------------------------------------------------

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        assert type(s) is str
        if self.tokenizer_type == "transformers":
            t = self.tokenizer.encode(s, truncation=False, add_special_tokens=False)
        else:
            t = self.tokenizer.encode(s)
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t

    def encode_segment(self, s: str) -> List[int]:
        """Encode a segment cut from a longer text so the tokens equal the
        corresponding slice of the tokenized full text."""
        s = s.lstrip(" ")
        if self.need_space_before_segment:
            return self.encode(" " + s, bos=False, eos=False)
        return self.encode(s, bos=False, eos=False)

    def encode_wo_prefix_space(self, s: str) -> List[int]:
        if self.need_space_before_segment:
            return self.encode(s, bos=False, eos=False)
        # find a prefix char that tokenizes independently, encode prefix+s,
        # and strip the prefix tokens (tokenizer.py:75-88)
        for prefix in ["@", "\n", "\\", "=", ">", "`"]:
            prefix_tokens = self.encode(prefix, bos=False, eos=False)
            cat_tokens = self.encode(prefix + s, bos=False, eos=False)
            if cat_tokens[: len(prefix_tokens)] == prefix_tokens:
                return cat_tokens[len(prefix_tokens):]
        raise NotImplementedError(
            f"all prefixes merged into {s!r} during tokenization"
        )

    def _probe_tokenizer_style(self) -> None:
        sentence1 = self.encode("Hi my darling", bos=False, eos=False)
        sentence2 = self.encode("my darling", bos=False, eos=False)
        if sentence1[-len(sentence2):] == sentence2:
            self.need_space_before_segment = False
        else:
            sentence3 = self.encode(" my darling", bos=False, eos=False)
            assert sentence1[-len(sentence3):] == sentence3
            self.need_space_before_segment = True

    # -- misc --------------------------------------------------------------

    def decode(self, t: List[int]) -> str:
        return self.tokenizer.decode(t)

    def id_to_piece(self, i: int) -> str:
        """Surface text of one token id: sentencepiece/Metaspace space
        markers ('▁') and GPT-style 'Ġ' map to ' ', byte-fallback pieces
        '<0xNN>' to their byte char, specials (bos/eos/unk/pad) to ''.
        Used by constrained decoding to walk token pieces through a
        character DFA (a3vlm_tpu_torch.constrained)."""
        if self.tokenizer_type == "transformers":
            p = self.tokenizer.convert_ids_to_tokens(int(i))
            if p is None or p in self.tokenizer.all_special_tokens:
                return ""
        else:  # pragma: no cover - spm wheel absent in CI
            if self.tokenizer.is_control(int(i)) or int(i) in (
                self.bos_id, self.eos_id,
            ):
                return ""
            p = self.tokenizer.id_to_piece(int(i))
        import re as _re

        if _re.fullmatch(r"<0x[0-9A-Fa-f]{2}>", p):
            return chr(int(p[3:5], 16))
        return p.replace("▁", " ").replace("Ġ", " ")

    def save(self, save_dir: str) -> None:
        if self.tokenizer_type == "transformers":
            self.tokenizer.save_pretrained(save_dir)
        else:  # pragma: no cover
            with open(Path(save_dir) / "tokenizer.model", "wb") as f:
                f.write(self.tokenizer.serialized_model_proto())

    @property
    def n_words(self) -> int:
        if self.tokenizer_type == "spm":  # pragma: no cover
            return self.tokenizer.vocab_size()
        return len(self.tokenizer)


def probe_tokenizer_path_from_pretrained(pretrained_path: str) -> str | None:
    """Find a tokenizer inside a checkpoint dir (tokenizer.py:134-156)."""
    p = Path(pretrained_path)
    if (p / "tokenizer.model").exists():
        return str(p / "tokenizer.model")
    if (p / "tokenizer.json").exists() and (p / "tokenizer_config.json").exists():
        return pretrained_path
    return None
