"""Single-turn instruction dataset (reference model/accessory/data/alpaca.py):
alpaca-style prompt formatting, labels masking the prompt, pad-with(-1)->0
semantics, per-type groups, MetaPreprocessor recipes.

Also covers the point-cloud variant (finetune_dataset_w_pointcloud.py:21):
META entries with type "point" load objaverse .npy clouds through
load_objaverse_point_cloud and return the [pointnum, 6] float32 cloud in
the "image" slot; ``image_words`` may be a {meta_type: words} dict so the
text budget differs per modality (finetune_dataset_w_pointcloud.py:196)."""

from __future__ import annotations

import json
from typing import Callable

import numpy as np
from PIL import Image

from a3vlm_tpu_torch.data.annotations import (
    cache_dir_for,
    read_h5_cache,
    write_h5_cache,
)
from a3vlm_tpu_torch.data.system_prompt import format_prompt


class MetaPreprocessor:
    """(alpaca.py:210-243)"""

    def __init__(self):
        self.routing = {
            "single_turn_llava": self._preprocess_single_turn_llava,
            "caption": self._preprocess_caption,
        }

    def preprocess(self, meta_l, recipe: str):
        return self.routing[recipe](meta_l)

    @staticmethod
    def _preprocess_single_turn_llava(meta_l):
        return [
            {
                "image": item["image"],
                "instruction": item["conversations"][0]["value"],
                "output": item["conversations"][1]["value"],
            }
            for item in meta_l
        ]

    @staticmethod
    def _preprocess_caption(meta_l):
        import random

        out = []
        for item in meta_l:
            caption = item["caption"]
            if isinstance(caption, list):
                caption = random.choice(caption)
            out.append({"image": item["url"], "output": caption})
        return out


class FinetuneDataset:
    def __init__(
        self,
        config_path: str,
        transform: Callable,
        max_words: int = 30,
        image_words: int = 257,
        tokenizer=None,
        cache_on_disk: bool = False,
        rank: int = 0,
    ):
        def sort_key(item):
            return len(
                format_prompt(item, item["sys_prompt"]) + item["output"]
            )

        def item_hook(item, meta):
            item["sys_prompt"] = meta.get("prompt_type", "alpaca")

        def preprocess_hook(item, meta):
            item_hook(item, meta)

        # META-level preprocess recipes need whole-list access; handled by
        # collecting manually per meta when requested.
        self.cache_on_disk = cache_on_disk
        if cache_on_disk:
            from pathlib import Path

            cache_dir = cache_dir_for(config_path)
            if rank == 0 and not (Path(cache_dir) / "ready").exists():
                ann, groups = self._collect(config_path, sort_key)
                write_h5_cache(cache_dir, ann, groups)
            self.ann, self.group_indices = read_h5_cache(cache_dir)
        else:
            self.ann, self.group_indices = self._collect(
                config_path, sort_key
            )

        self.transform = transform
        self.max_words = max_words
        self.image_words = image_words
        self.tokenizer = tokenizer

    @staticmethod
    def _collect(config_path, sort_key):
        import yaml

        from a3vlm_tpu_torch.data.annotations import _read_meta_file

        with open(config_path) as f:
            config = yaml.safe_load(f)
        group_ann: dict[str, list] = {}
        for meta in config["META"]:
            meta_l = _read_meta_file(meta["path"])
            if meta.get("preprocess") is not None:
                meta_l = MetaPreprocessor().preprocess(
                    meta_l, meta["preprocess"]
                )
            prompt_type = meta.get("prompt_type", "alpaca")
            for item in meta_l:
                item["sys_prompt"] = prompt_type
                item["meta_type"] = meta["type"]
            group_ann.setdefault(meta["type"], []).extend(meta_l)
        for meta_l in group_ann.values():
            meta_l.sort(key=sort_key)
        ann = sum(group_ann.values(), start=[])
        group_indices = {}
        start = 0
        for meta_type, meta_l in group_ann.items():
            group_indices[meta_type] = list(
                range(start, start + len(meta_l))
            )
            start += len(meta_l)
        return ann, group_indices

    def __len__(self):
        return len(self.ann)

    def groups(self):
        return list(self.group_indices.values())

    def __getitem__(self, index):
        data_item = self.ann[index]
        if self.cache_on_disk:
            data_item = json.loads(data_item)

        meta_type = data_item.get("meta_type", "image_text")
        image = data_item.get("image")
        if image is not None:
            if meta_type == "point":
                from a3vlm_tpu_torch.data.transforms import (
                    load_objaverse_point_cloud,
                )

                image = load_objaverse_point_cloud(
                    image, use_color=True
                ).astype(np.float32)
            else:
                image = self.transform(Image.open(image).convert("RGB"))

        answer = data_item["output"]
        input1 = format_prompt(data_item, data_item["sys_prompt"])
        input2 = input1 + answer
        t1 = self.tokenizer.encode(input1, bos=True, eos=False)
        t2 = np.asarray(
            self.tokenizer.encode(input2, bos=True, eos=True), np.int64
        )

        image_words = (
            self.image_words.get(meta_type, 0)
            if isinstance(self.image_words, dict)
            else self.image_words
        )
        max_words = self.max_words - (
            image_words if image is not None else 0
        )
        padding = max_words - t2.shape[0]
        if padding > 0:
            t2 = np.concatenate([t2, np.full(padding, -1, np.int64)])
        elif padding < 0:
            t2 = t2[:max_words]
        labels = t2.copy()
        labels[: len(t1)] = -1
        mask = (t2 >= 0).astype(np.float32)
        t2 = np.where(t2 >= 0, t2, 0)
        labels = np.where(labels >= 0, labels, 0)

        out = {"examples": t2, "labels": labels, "mask": mask}
        if image is not None:
            out["image"] = np.asarray(image, np.float32)
        return out
