"""Shared annotation collection for the finetune datasets (the config/cache
machinery duplicated across reference data/alpaca.py:20-149 and
data/conversation/dataset.py:66-192):

- YAML META list with per-source path, type, ratio, root and preprocess
- .json/.jsonl/.csv readers
- deterministic ratio subsampling (random.seed(0), dataset.py:141-144)
- per-type groups sorted by a length key (type-homogeneous batching relies
  on the contiguous group index ranges)
- optional h5 on-disk cache: rank 0 builds, other processes poll the
  ``ready`` sentinel file (alpaca.py:126-149)
"""

from __future__ import annotations

import json
import os
import random
import time
from pathlib import Path
from typing import Any, Callable, Optional

import yaml


def _read_meta_file(meta_path: str) -> list[dict]:
    ext = os.path.splitext(meta_path)[-1]
    if ext == ".json":
        with open(meta_path) as f:
            return json.load(f)
    if ext == ".jsonl":
        out = []
        with open(meta_path) as f:
            for i, line in enumerate(f):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    raise ValueError(
                        f"error decoding jsonl line ({i}) of {meta_path}: "
                        f"{line.rstrip()!r}"
                    )
        return out
    if ext == ".csv":
        import pandas as pd

        return pd.read_csv(meta_path, sep="\t").to_dict(orient="records")
    raise NotImplementedError(f'unknown meta file extension: "{ext}"')


def collect_annotations(
    config_path: str,
    sort_key: Callable[[dict], Any],
    item_hook: Optional[Callable[[dict, dict], None]] = None,
) -> tuple[list[dict], dict[str, list[int]]]:
    """Returns (ann, group_indices). ``item_hook(item, meta_cfg)`` may mutate
    each item (root-joining, sys_prompt tagging, value stringification)."""
    with open(config_path) as f:
        config = yaml.safe_load(f)

    group_ann: dict[str, list[dict]] = {}
    for meta in config["META"]:
        meta_l = _read_meta_file(meta["path"])
        if "ratio" in meta:
            random.seed(0)
            meta_l = random.sample(meta_l, int(len(meta_l) * meta["ratio"]))
        if "root" in meta:
            for item in meta_l:
                if "image" in item:
                    item["image"] = str(Path(meta["root"]) / item["image"])
        if item_hook is not None:
            for item in meta_l:
                item_hook(item, meta)
        meta_type = meta["type"]
        group_ann.setdefault(meta_type, []).extend(meta_l)

    for meta_l in group_ann.values():
        meta_l.sort(key=sort_key)

    ann = sum(group_ann.values(), start=[])
    group_indices: dict[str, list[int]] = {}
    start = 0
    for meta_type, meta_l in group_ann.items():
        group_indices[meta_type] = list(range(start, start + len(meta_l)))
        start += len(meta_l)
    return ann, group_indices


def cache_dir_for(config_path: str, base: str = "./a3vlm_data_cache") -> str:
    ident = config_path
    for ch in ["/", "\\", ".", "?", "!"]:
        ident = ident.replace(ch, "-")
    return f"{base}/{ident}"


def write_h5_cache(cache_dir: str, ann: list[dict], group_indices) -> None:
    import h5py

    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    serialized = [json.dumps(_) for _ in ann]
    group_range = {
        k: [v[0], v[-1] + 1] for k, v in group_indices.items()
    }
    with h5py.File(Path(cache_dir) / "data.h5", "w") as f:
        dt = h5py.vlen_dtype(str)
        f.create_dataset("ann", data=serialized, dtype=dt)
        f.create_dataset("group_indice_range", data=json.dumps(group_range))
    (Path(cache_dir) / "ready").touch()


def read_h5_cache(cache_dir: str, timeout_s: float = 3600.0):
    """Poll for the ready file (processes that do not build it, alpaca.py:143-149),
    then open the h5 cache. Returns (h5_ann_dataset, group_indices)."""
    import h5py

    ready = Path(cache_dir) / "ready"
    t0 = time.time()
    while not ready.exists():
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"h5 cache never became ready in {cache_dir}")
        time.sleep(1)
    f = h5py.File(Path(cache_dir) / "data.h5", "r")
    group_range = json.loads(f["group_indice_range"].asstr()[()])
    group_indices = {
        k: list(range(v[0], v[1])) for k, v in group_range.items()
    }
    return f["ann"], group_indices
