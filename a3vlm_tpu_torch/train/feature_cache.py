"""Tower-feature cache: skip the frozen vision towers after epoch 0
(counterpart of a3vlm_tpu/train/feature_cache.py).

The recipe freezes all four vision towers; only the projectors, image
tags and the decoder train. The towers' pre-projection features are
therefore constant per image for the whole run. ``TowerFeatureCache``
computes ``ens5.encode_image_features`` (the BLIP-2 Q-Former queries and
the CLIP + ConvNeXt + DINOv2 ensemble, before the projectors) once per
dataset index, on the device at the batch's full width and in the towers'
dtype, and replays it afterwards; ``FeatureCachingLoader`` wraps a
``DataLoader`` made with ``with_indices=True`` and swaps each batch's
``image`` for ``image_feat_q`` / ``image_feat_ens``, which
``ens5.forward`` takes as ``image_features``. Epoch 0 runs the towers
once per image; every later epoch runs none.

The features are kept as host tensors in their dtype, so a cached step is
bit for bit the uncached one. ``cache_dir`` spills one ``.npz`` per index
instead of holding the epoch in RAM, in the JAX package's format (bf16 as
a ``uint16`` view plus a ``<key>_bf16`` flag): a cache one package wrote,
the other reads."""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from a3vlm_tpu_torch.models import ens5

_KEYS = ("q", "ens")


def _to_disk(path: str, per_img: dict) -> None:
    arrs = {}
    for k in _KEYS:
        t = per_img[k]
        if t.dtype == torch.bfloat16:
            arrs[k] = t.view(torch.int16).numpy().view(np.uint16)
            arrs[k + "_bf16"] = np.asarray(True)
        else:
            arrs[k] = t.numpy()
    np.savez(path, **arrs)


def _from_disk(path: str) -> dict:
    with np.load(path) as z:
        out = {}
        for k in _KEYS:
            a = z[k]
            if k + "_bf16" in z:
                out[k] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                out[k] = torch.from_numpy(a)
        return out


class TowerFeatureCache:
    """Per-dataset-index store of frozen tower features.

    ``params`` is the full ens5 tree (the tower subtrees are held by
    reference: frozen, they never go stale), ``cfg`` the ``Ens5Config``.
    ``get_batch(indices, images)`` returns the ``encode_image_features``
    dict of the batch, computing and storing a batch that holds any miss
    in one device call over the whole batch."""

    def __init__(self, params, cfg, cache_dir: Optional[str] = None):
        self.cfg = cfg
        self._towers = {k: params[k] for k in ens5.FROZEN_PREFIXES}
        self._ram: dict[int, dict] = {}
        self._dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.computed = 0  # batches that ran the towers

    # -- storage ----------------------------------------------------------
    def _path(self, idx: int) -> str:
        return os.path.join(self._dir, f"feat_{idx}.npz")

    def _have(self, idx: int) -> bool:
        if idx in self._ram:
            return True
        return bool(self._dir) and os.path.exists(self._path(idx))

    def _load(self, idx: int) -> dict:
        if idx in self._ram:
            return self._ram[idx]
        return _from_disk(self._path(idx))

    def _store(self, idx: int, per_img: dict) -> None:
        if self._dir:
            _to_disk(self._path(idx), per_img)
        else:
            self._ram[idx] = per_img

    # -- batch API ---------------------------------------------------------
    def get_batch(self, indices, images) -> dict:
        """indices: [B] ints; images: [B, H, W, 3] (read only on a miss;
        numpy or a tensor, taken to the towers' device and dtype). Returns
        {"q": [5B, nq, Dq], "ens": [5B, 257, De]} host tensors, laid out as
        ``encode_image_features`` lays them (crop-major: row b + c*B is
        image b's crop c)."""
        indices = [int(i) for i in indices]
        B = len(indices)
        if all(self._have(i) for i in indices):
            per = [self._load(i) for i in indices]
            # per-image [5, T, D] -> crop-major [5B, T, D]
            return {k: torch.stack([p[k] for p in per], dim=1).reshape(
                5 * B, *per[0][k].shape[1:]) for k in _KEYS}
        ref = self._towers["clip"]["class_embedding"]
        images = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images).to(ref.device, ref.dtype)
        feats = ens5.encode_image_features(self._towers, self.cfg, images)
        self.computed += 1
        out = {k: feats[k].cpu() for k in _KEYS}
        for pos, idx in enumerate(indices):
            self._store(idx, {
                k: out[k].reshape(5, B, *out[k].shape[1:])[:, pos].clone()
                for k in _KEYS})
        return out


class FeatureCachingLoader:
    """Wrap a DataLoader (``with_indices=True``) so every multimodal batch
    carries ``image_feat_q`` / ``image_feat_ens`` in place of ``image``.
    Caches each micro-batch of a gradient-accumulation batch ([accum, bs,
    ...] leaves). A batch without an ``image`` key passes through as it
    is, a ``depth_image``-only batch too (feature_cache.py:171). The
    depth stream of the 2-images variant is not cached here."""

    def __init__(self, loader, cache: TowerFeatureCache):
        self.loader = loader
        self.cache = cache

    def __len__(self) -> int:
        return len(self.loader)

    def close(self):
        self.loader.close()

    def _swap(self, idx, img) -> dict:
        f = self.cache.get_batch(idx, img)
        return {"image_feat_q": f["q"], "image_feat_ens": f["ens"]}

    def __iter__(self) -> Iterator[dict]:
        for batch in self.loader:
            idx = batch.pop("_indices", None)
            if "image" not in batch:
                yield batch
                continue
            if idx is None:
                raise ValueError(
                    "FeatureCachingLoader needs DataLoader(with_indices=True)")
            img = batch.pop("image")
            if img.ndim == 5 and idx.ndim == 2:  # [accum, bs, H, W, 3]
                per = [self._swap(idx[a], img[a]) for a in range(img.shape[0])]
                for k in per[0]:
                    batch[k] = torch.stack([p[k] for p in per])
            else:
                batch.update(self._swap(idx, img))
            yield batch
