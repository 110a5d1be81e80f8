"""Streaming pretraining datasets (reference model/accessory/data/falcon.py
and falcon_packed.py): iterable token streams with file-level sharding over
(process x worker) and resumable state.

- ``FalconStreamDataset``: parquet (or jsonl) documents, tokenized on the
  fly (falcon.py:15-).
- ``FalconPackedDataset``: pre-packed fixed-length token blocks from .pkl
  files (falcon_packed.py:16-, produced by tools/generate_packed_data.py).
"""

from __future__ import annotations

import pickle
from typing import Iterator

import numpy as np


class _FileShardedIterable:
    """File-level sharding over (num_processes x num_workers)
    (falcon.py:52-60) with {file_idx, row_idx} resume state."""

    def __init__(self, files: list[str], process_rank=0, num_processes=1):
        self.files = sorted(files)
        self.process_rank = process_rank
        self.num_processes = num_processes
        self.state = {"file_idx": 0, "row_idx": 0}

    def own_files(self) -> list[tuple[int, str]]:
        return [
            (i, f)
            for i, f in enumerate(self.files)
            if i % self.num_processes == self.process_rank
        ]

    def set_state(self, state: dict) -> None:
        self.state = dict(state)

    def get_state(self) -> dict:
        return dict(self.state)


class FalconStreamDataset(_FileShardedIterable):
    """Yields raw text documents -> fixed-window token rows."""

    def __init__(
        self, files, tokenizer, seq_len: int = 2048, process_rank=0,
        num_processes=1,
    ):
        super().__init__(files, process_rank, num_processes)
        self.tokenizer = tokenizer
        self.seq_len = seq_len

    def _read_rows(self, path: str):
        if path.endswith(".parquet"):
            import pandas as pd

            df = pd.read_parquet(path)
            col = "content" if "content" in df.columns else df.columns[0]
            yield from df[col].tolist()
        else:
            import json

            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    yield rec.get("content") or rec.get("text", "")

    def __iter__(self) -> Iterator[np.ndarray]:
        buffer: list[int] = []
        for file_idx, path in self.own_files():
            if file_idx < self.state["file_idx"]:
                continue
            for row_idx, text in enumerate(self._read_rows(path)):
                if (
                    file_idx == self.state["file_idx"]
                    and row_idx < self.state["row_idx"]
                ):
                    continue
                self.state = {"file_idx": file_idx, "row_idx": row_idx}
                buffer += self.tokenizer.encode(text, bos=True, eos=True)
                while len(buffer) >= self.seq_len:
                    yield np.asarray(buffer[: self.seq_len], np.int64)
                    buffer = buffer[self.seq_len:]
            self.state = {"file_idx": file_idx + 1, "row_idx": 0}


class FalconPackedDataset(_FileShardedIterable):
    """Yields pre-packed fixed-length rows from .pkl block files."""

    def __iter__(self) -> Iterator[np.ndarray]:
        for file_idx, path in self.own_files():
            if file_idx < self.state["file_idx"]:
                continue
            with open(path, "rb") as f:
                blocks = pickle.load(f)
            start = (
                self.state["row_idx"]
                if file_idx == self.state["file_idx"]
                else 0
            )
            for row_idx in range(start, len(blocks)):
                self.state = {"file_idx": file_idx, "row_idx": row_idx}
                yield np.asarray(blocks[row_idx], np.int64)
            self.state = {"file_idx": file_idx + 1, "row_idx": 0}
