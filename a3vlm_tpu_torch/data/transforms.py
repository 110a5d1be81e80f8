"""Host-side image transforms producing NHWC float32 arrays for the device
pipeline (reference model/accessory/data/transform.py).

Output contract: CLIP-normalized channels-LAST numpy arrays (the layout the
models take) — the reference's CHW tensors transposed.

- ``PadToSquare``: pad with the CLIP-mean background color (:13-36)
- ``padded_resize``: pad -> bicubic resize -> normalize (:59-67; the A3VLM
  train/eval transform, a3vlm_train.sh:54)
- ``resized_center_crop``, ``random_resized_crop`` (:39-56)

Point-cloud loaders (:82-158): 6-dim xyzrgb clouds, normalization, FPS.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class PadToSquare:
    def __init__(self, background_color=tuple(CLIP_MEAN)):
        self.bg_color = tuple(int(x * 255) for x in background_color)

    def __call__(self, img: Image.Image) -> Image.Image:
        width, height = img.size
        if width == height:
            return img
        side = max(width, height)
        result = Image.new(img.mode, (side, side), self.bg_color)
        if width > height:
            result.paste(img, (0, (width - height) // 2))
        else:
            result.paste(img, ((height - width) // 2, 0))
        return result


def _normalize(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD  # [H, W, 3]


def padded_resize(img: Image.Image, size: int = 224) -> np.ndarray:
    img = PadToSquare()(img)
    img = img.resize((size, size), Image.BICUBIC)
    return _normalize(img)


def resized_center_crop(img: Image.Image, size: int = 224) -> np.ndarray:
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return _normalize(img)


def random_resized_crop(
    img: Image.Image, size: int = 224, rng: np.random.Generator | None = None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.9, 1.0)
        aspect = np.exp(rng.uniform(np.log(0.75), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            left = rng.integers(0, w - cw + 1)
            top = rng.integers(0, h - ch + 1)
            img = img.crop((left, top, left + cw, top + ch))
            break
    img = img.resize((size, size), Image.BICUBIC)
    return _normalize(img)


def get_transform(transform_type: str, size: int = 224):
    """(transform.py:70-79)"""
    table = {
        "padded_resize": padded_resize,
        "resized_center_crop": resized_center_crop,
        "random_resized_crop": random_resized_crop,
    }
    if transform_type not in table:
        raise ValueError(f"unknown transform type: {transform_type}")
    fn = table[transform_type]
    return lambda img: fn(img, size)


# ---------------------------------------------------------------------------
# point clouds (transform.py:82-158)
# ---------------------------------------------------------------------------


def pc_norm(pc: np.ndarray) -> np.ndarray:
    """Center xyz and scale to the unit sphere; colors normalized to [0, 1]
    (/255 when the input looks like uint8 values) and clipped
    (transform.py:82-100). NOTE: like the reference, the live objaverse
    loader below does NOT call this — it is kept for callers that want an
    explicitly normalized cloud."""
    xyz = pc[:, :3]
    rgb = pc[:, 3:]
    centroid = xyz.mean(axis=0)
    xyz = xyz - centroid
    m = np.max(np.sqrt(np.sum(xyz**2, axis=1)))
    xyz = xyz / (m + 1e-8)
    if rgb.shape[1] > 0:
        if np.max(rgb) > 1:
            rgb = rgb / 255.0
        rgb = np.clip(rgb, 0.0, 1.0)
    return np.concatenate([xyz, rgb], axis=1).astype(np.float32)


def farthest_point_sample(points: np.ndarray, npoint: int) -> np.ndarray:
    """FPS over xyz (transform.py:137-158); vectorized numpy."""
    N = points.shape[0]
    if N <= npoint:
        return points
    xyz = points[:, :3]
    idx = np.zeros(npoint, dtype=np.int64)
    dist = np.full(N, np.inf)
    farthest = 0
    for i in range(npoint):
        idx[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, axis=1)
        dist = np.minimum(dist, d)
        farthest = int(np.argmax(dist))
    return points[idx]


def load_objaverse_point_cloud(
    filename: str,
    pointnum: int = 8192,
    use_color: bool = True,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Load a .npy point cloud with the reference's exact live semantics
    (transform.py:102-132): 9-dim clouds keep columns [0,1,2,6,7,8]
    (xyz + rgb, dropping normals); rgb is /255-normalized only when it
    looks like uint8 values; clouds smaller than ``pointnum`` are TILED UP
    to size; larger ones are randomly subsampled without replacement.
    pc_norm is deliberately NOT applied — the reference commented it out
    and every live call site (eval_affordance_with_quant.py:188,
    data_reader.py:9, finetune_dataset_w_pointcloud.py:185) consumes the
    raw-coordinate cloud."""
    pc = np.load(filename).astype(np.float64, copy=True)
    if pc.shape[1] == 9:
        pc = pc[:, [0, 1, 2, 6, 7, 8]]
    if pc.shape[1] >= 6 and np.max(pc[:, 3:]) > 1:
        pc[:, 3:] = pc[:, 3:] / 255.0
    if pc.shape[0] < pointnum:
        duplicate_num = pointnum // pc.shape[0] + 1
        pc = np.tile(pc, (duplicate_num, 1))[:pointnum]
    if pc.shape[0] > pointnum:
        rng = np.random.default_rng(0) if rng is None else rng
        choice = rng.choice(pc.shape[0], pointnum, replace=False)
        pc = pc[choice, :]
    if not use_color:
        pc = pc[:, :3]
        assert pc.shape[1] == 3
    else:
        assert pc.shape[1] == 6
    return pc


# Back-compat name used by earlier rounds; same loader.
load_point_cloud = load_objaverse_point_cloud
