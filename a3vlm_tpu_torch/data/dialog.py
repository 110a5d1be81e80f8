"""Multi-turn dialog finetune dataset — the dataset A3VLM trains on
(reference model/accessory/data/conversation/dataset.py, used with --dialog,
a3vlm_train.sh:52; the _2_images and _w_pc variants are option flags here
instead of copied files).

Semantics carried over:
- "###Human/###Assistant" transcript via the conversation template; labels
  built by sub-list search of each tokenized assistant span inside the
  tokenized conversation (:232-244) — requires ``encode_segment``.
- ``<image>`` placeholder stripped (:226).
- pad to (max_words - image_words) with -1; -1 positions masked to 0 in both
  tokens and labels (:250-266) — label id 0 is the CE ignore index.
- on any per-item error, deterministic fallback to the neighbor index within
  the same group (:275-290).
- items return numpy, channels-last images.
"""

from __future__ import annotations

import json
import warnings
from typing import Callable, Optional

import numpy as np

from a3vlm_tpu_torch.data.annotations import (
    cache_dir_for,
    collect_annotations,
    read_h5_cache,
    write_h5_cache,
)
from a3vlm_tpu_torch.data.conversation import ConversationGenerator
from a3vlm_tpu_torch.data.data_reader import read_img_general

IGNORE_INDEX = -100


class LabelAllZeroError(Exception):
    pass


def find_sublist(a: list, b: list) -> int:
    """(conversation/dataset.py:295-300)"""
    len_a, len_b = len(a), len(b)
    for i in range(len_a - len_b + 1):
        if a[i : i + len_b] == b:
            return i
    return -1


class FinetuneDialogDataset:
    def __init__(
        self,
        config_path: str,
        transform: Callable,
        max_words: int = 30,
        image_words: int = 257,
        tokenizer=None,
        cache_on_disk: bool = False,
        rank: int = 0,
        with_depth: bool = False,
        with_point_cloud: bool = False,
        depth_transform: Optional[Callable] = None,
    ):
        def sort_key(item):
            return sum(len(t["value"]) for t in item["conversations"])

        def item_hook(item, _meta):
            for turn in item["conversations"]:
                if not isinstance(turn["value"], str):
                    turn["value"] = str(turn["value"])

        self.cache_on_disk = cache_on_disk
        self._h5_file = None
        if cache_on_disk:
            cache_dir = cache_dir_for(config_path)
            from pathlib import Path

            if rank == 0 and not (Path(cache_dir) / "ready").exists():
                ann, groups = collect_annotations(
                    config_path, sort_key, item_hook
                )
                write_h5_cache(cache_dir, ann, groups)
            self.ann, self.group_indices = read_h5_cache(cache_dir)
        else:
            self.ann, self.group_indices = collect_annotations(
                config_path, sort_key, item_hook
            )

        self.transform = transform
        self.depth_transform = depth_transform or transform
        self.max_words = max_words
        self.image_words = image_words
        self.with_depth = with_depth
        self.with_point_cloud = with_point_cloud
        self.tokenizer = tokenizer
        self.conversation_generator = ConversationGenerator(tokenizer)

    def __len__(self):
        return len(self.ann)

    def groups(self):
        return list(self.group_indices.values())

    def _raw_item(self, index) -> dict:
        item = self.ann[index]
        if self.cache_on_disk:
            item = json.loads(item)
        return item

    def get_item_func(self, index: int):
        data_item = self._raw_item(index)

        image = None
        depth_image = None
        point_cloud = None
        if "image" in data_item:
            filename = data_item["image"]
            if self.with_point_cloud and filename.endswith(".npy"):
                point_cloud = read_img_general(filename)
            else:
                image = self.transform(read_img_general(filename))
        if self.with_depth:
            if image is None:
                raise ValueError("2-image variant requires an image per item")
            depth_image = self.depth_transform(
                read_img_general(data_item["depth_image"])
            )

        source = data_item["conversations"]
        for turn in source:
            turn["value"] = turn["value"].replace("<image>", "").strip()
        conversation, to_predict_values = (
            self.conversation_generator.add_speaker_and_signal(source)
        )
        if len(to_predict_values) == 0:
            warnings.warn(f"dialog item with nothing to predict: {data_item}")
            return self[index - 1]

        tokenized = self.tokenizer.encode(conversation, bos=True, eos=True)
        labels = [IGNORE_INDEX] * len(tokenized)

        check_pos = 0
        for value in to_predict_values:
            tokenized_value = self.tokenizer.encode_segment(value)
            value_pos = find_sublist(tokenized[check_pos:], tokenized_value)
            if value_pos == -1:
                warnings.warn(
                    "a sentence mismatches the corresponding piece in the "
                    "conversation"
                )
                return self[index - 1]
            value_pos += check_pos
            labels[value_pos : value_pos + len(tokenized_value)] = (
                tokenized_value
            )
            assert (
                labels[value_pos : value_pos + len(tokenized_value)]
                == tokenized[value_pos : value_pos + len(tokenized_value)]
            )
            check_pos = value_pos + len(tokenized_value)

        tokens = np.asarray(tokenized, np.int64)
        labels = np.asarray(labels, np.int64)

        has_visual = image is not None or point_cloud is not None
        max_words = self.max_words - (
            self.image_words * (2 if self.with_depth else 1)
            if has_visual
            else 0
        )
        padding = max_words - tokens.shape[0]
        if padding > 0:
            tokens = np.concatenate(
                [tokens, np.full(padding, -1, np.int64)]
            )
            labels = np.concatenate(
                [labels, np.full(padding, -1, np.int64)]
            )
        elif padding < 0:
            tokens = tokens[:max_words]
            labels = labels[:max_words]

        mask = (tokens >= 0).astype(np.float32)
        tokens = np.where(tokens >= 0, tokens, 0)
        labels = np.where(labels >= 0, labels, 0)

        if np.count_nonzero(labels) == 0:
            raise LabelAllZeroError()

        out = {"examples": tokens, "labels": labels, "mask": mask}
        if image is not None:
            out["image"] = np.asarray(image, np.float32)
        if depth_image is not None:
            out["depth_image"] = np.asarray(depth_image, np.float32)
        if point_cloud is not None:
            out["point_cloud"] = np.asarray(point_cloud, np.float32)
        return out

    def __getitem__(self, index: int, _depth: int = 0):
        try:
            return self.get_item_func(index)
        except Exception as e:
            if not isinstance(e, LabelAllZeroError):
                warnings.warn(f"item {index} errored: {e!r}")
            # deterministic neighbor fallback within the group (:275-290),
            # bounded so a fully-broken group raises instead of recursing
            # forever (e.g. every item truncated past its labels)
            for indices in self.group_indices.values():
                if indices[0] <= index <= indices[-1]:
                    if _depth >= len(indices):
                        raise RuntimeError(
                            f"every item in the group containing index "
                            f"{index} fails to load (last error: {e!r}); "
                            f"check max_words vs prompt length and the "
                            f"tokenizer's segment alignment"
                        ) from e
                    new_index = (
                        indices[-1] if index == indices[0] else index - 1
                    )
                    return self.__getitem__(new_index, _depth + 1)
            raise
