"""Triad (B, A, S) string codecs — the output-format contract
(SURVEY.md §2.3; reference data_gen/vqa_task_construction.py).

Byte-compatible formatters:
- 2D rotated box "[cx,cy,w,h,angle]" 2-dec normalized (ref :121-151)
- joint answers "<rb>{type}</rb>[...]" (+depth "<rbd>[d0,d1]</rbd>") (:191-261)
- 3D 9-dof box "[c,e,rotvec]" and 8-corner projected "[[x,y,z]x8]" (:441-491)
- 3D axis "<axis>{type}</axis>[x0,y0,z0,x1,y1,z1]" (:494-501,536)
- det-all answer sentences with number words and the 10-largest cap
  (:163-187, :569-599)

plus parsers for eval, and the VQA-task builder functions producing
``{"image": ..., "conversations": [...]}`` records.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from a3vlm_tpu_torch.codecs import vocab as V
from a3vlm_tpu_torch.codecs.geometry import BBox3D, project_points


# ---------------------------------------------------------------------------
# normalization helpers (vqa_task_construction.py:425-438)
# ---------------------------------------------------------------------------


def normalize_val(val, min_val=-1.0, max_val=1.0, scale=100.0):
    val = np.asarray(val, dtype=np.float64)
    val = (val - min_val) / (max_val - min_val) * scale
    return np.round(val).astype(int)


def unnormalize_val(val, min_val=-1.0, max_val=1.0, scale=100.0):
    val = np.asarray(val, dtype=np.float64)
    return val / scale * (max_val - min_val) + min_val


def get_pad(width: int, height: int):
    """Pad-to-square offsets (vqa_task_construction.py:95-108)."""
    if width < height:
        return int((height - width) / 2), 0
    return 0, int((width - height) / 2)


# ---------------------------------------------------------------------------
# 2D codecs
# ---------------------------------------------------------------------------


def format_rotated_box(
    box: Sequence[float],
    image_width: int = 960,
    image_height: int = 960,
    pad_x0: int = 0,
    pad_y0: int = 0,
    with_depth: bool = False,
) -> str:
    """"[cx,cy,w,h,angle]" normalized to the padded square, 2 decimals
    (vqa_task_construction.py:121-151). ``with_depth`` appends depth1 (the
    6-element variant of :147-149)."""
    if with_depth:
        cx, cy, w, h, angle, depth1, _depth2 = box
    else:
        cx, cy, w, h, angle = box[:5]
    scx = (cx + pad_x0) / image_width
    scy = (cy + pad_y0) / image_height
    sw = w / image_width
    sh = h / image_height
    if with_depth:
        return "[{:.2f},{:.2f},{:.2f},{:.2f},{:.2f},{:.2f}]".format(
            scx, scy, sw, sh, angle, depth1
        )
    return "[{:.2f},{:.2f},{:.2f},{:.2f},{:.2f}]".format(scx, scy, sw, sh, angle)


def scale_rotated_box(
    box, image_width=960, image_height=960, pad_x0=0, pad_y0=0
) -> tuple[float, ...]:
    cx, cy, w, h, angle = box[:5]
    return (
        (cx + pad_x0) / image_width,
        (cy + pad_y0) / image_height,
        w / image_width,
        h / image_height,
        angle,
    )


def format_joint_answer(joint_type: str, box_str: str) -> str:
    """"<rb>{type}</rb>[...]" (vqa_task_construction.py:206)."""
    return V.DELIM_RB_START + joint_type + V.DELIM_RB_END + box_str


def format_depth_ext(depth0: float, depth1: float) -> str:
    return "[{:.2f},{:.2f}]".format(depth0, depth1)


# ---------------------------------------------------------------------------
# 3D codecs
# ---------------------------------------------------------------------------


def format_bbox_3d(
    bbox_3d: Sequence[float],
    anno_meta: Optional[dict] = None,
    normalize: bool = False,
    use_eight_points: bool = False,
) -> str:
    """9-dof "[cx,cy,cz,ex,ey,ez,rx,ry,rz]" or (the shipped default,
    partnet_label.py:915) the 8-corner projected "[[x,y,z]x8]"
    (vqa_task_construction.py:441-491)."""
    bbox_3d = np.asarray(bbox_3d, dtype=np.float64)
    if not use_eight_points:
        center, size, orientation = bbox_3d[:3], bbox_3d[3:6], bbox_3d[6:]
        if normalize:
            center = normalize_val(center, -1.0, 1.0)
            size = normalize_val(size, 0.0, 2.0)
            orientation = normalize_val(orientation, -np.pi, np.pi)
        return (
            f"[{center[0]:.2f},{center[1]:.2f},{center[2]:.2f},"
            f"{size[0]:.2f},{size[1]:.2f},{size[2]:.2f},"
            f"{orientation[0]:.2f},{orientation[1]:.2f},{orientation[2]:.2f}]"
        )
    box = BBox3D(bbox_3d[:3], bbox_3d[3:6], bbox_3d[6:])
    pts = box.get_bbox_3d_proj(
        anno_meta["intrinsics"],
        anno_meta["camera_pose"],
        anno_meta["depth_min"],
        anno_meta["depth_max"],
        anno_meta["img_width"],
        anno_meta["img_height"],
    )
    if normalize:
        pts = normalize_val(pts, -1.0, 1.0)
    return (
        "["
        + ",".join("[{:.2f},{:.2f},{:.2f}]".format(*p) for p in pts)
        + "]"
    )


def format_axis_3d(
    axis_3d, anno_meta: dict, normalize: bool = True
) -> str:
    """Two 3D endpoints projected to pixel space
    (vqa_task_construction.py:494-501)."""
    axis_3d = np.asarray(axis_3d, dtype=np.float64)
    if normalize:
        axis_3d = normalize_val(axis_3d, -1.0, 1.0)
    pts = project_points(
        axis_3d,
        anno_meta["intrinsics"],
        anno_meta["camera_pose"],
        anno_meta["depth_min"],
        anno_meta["depth_max"],
        anno_meta["img_width"],
        anno_meta["img_height"],
    )
    return "[{:.2f},{:.2f},{:.2f},{:.2f},{:.2f},{:.2f}]".format(
        pts[0][0], pts[0][1], pts[0][2], pts[1][0], pts[1][1], pts[1][2]
    )


def format_axis_answer(joint_type: str, axis_str: str) -> str:
    return V.DELIM_AXIS_START + joint_type + V.DELIM_AXIS_END + axis_str


# ---------------------------------------------------------------------------
# det-all answer sentences
# ---------------------------------------------------------------------------


def _det_all_answer(
    items: list[dict], key: str, fmt, start_delim: str, end_delim: str,
    noun: str, noun_plural: str, max_det: int = 10,
) -> str:
    if len(items) > max_det:
        items = sorted(
            items, key=lambda k: k["bbox"][2] * k["bbox"][3], reverse=True
        )[:max_det]
    n = V.NUMBER_WORDS[len(items)]
    if n == "one":
        answer = f"There is one manipulable object part with its {noun}: "
    else:
        answer = (
            f"There are {n} manipulable object parts with their {noun_plural}: "
        )
    for i, item in enumerate(items):
        box_str = fmt(item[key])
        sep = "." if i == len(items) - 1 else ","
        answer += start_delim + item["link_name"] + end_delim + box_str + sep
    return answer


def det_all_rotated_answer(items: list[dict], max_det: int = 10) -> str:
    """(vqa_task_construction.py:163-187); item: {"bbox": [cx,cy,w,h,angle],
    "link_name": str} with bbox already scaled or raw + fmt kwargs via
    functools.partial upstream."""
    return _det_all_answer(
        items, "bbox", lambda b: format_rotated_box(b),
        V.DELIM_RB_START, V.DELIM_RB_END, "rotated bounding box",
        "rotated bounding boxes", max_det,
    )


def det_all_3d_answer(
    items: list[dict], anno_meta: dict, normalize=False,
    use_eight_points=False, max_det: int = 10,
) -> str:
    """(vqa_task_construction.py:569-599); items sorted by 2D bbox area."""
    return _det_all_answer(
        items,
        "bbox_3d",
        lambda b: format_bbox_3d(
            b, anno_meta=anno_meta, normalize=normalize,
            use_eight_points=use_eight_points,
        ),
        V.DELIM_BOX_START,
        V.DELIM_BOX_END,
        "3d bounding box",
        "3d bounding boxes",
        max_det,
    )


# ---------------------------------------------------------------------------
# VQA record builders
# ---------------------------------------------------------------------------


def vqa_record(image_path: str, question: str, answer: str) -> dict:
    """The VQA JSON schema coupling datagen to training
    (vqa_task_construction.py:158, conversation/dataset.py:224-227)."""
    return {
        "image": image_path,
        "conversations": [
            {"from": "human", "value": question},
            {"from": "gpt", "value": answer},
        ],
    }


# ---------------------------------------------------------------------------
# parsers (eval side)
# ---------------------------------------------------------------------------

_BOX_2D_RE = re.compile(r"\[([-\d.,\s]+)\]")
_TAG_RE = re.compile(r"<(rb|rbd|box|axis)>(.*?)</\1>")


def parse_rotated_box(s: str) -> Optional[list[float]]:
    m = _BOX_2D_RE.search(s)
    if not m:
        return None
    try:
        return [float(x) for x in m.group(1).split(",") if x.strip()]
    except ValueError:
        return None


def parse_tagged_answer(s: str) -> tuple[Optional[str], Optional[str], str]:
    """Split "<tag>{label}</tag>rest" -> (tag, label, rest-after-tag)."""
    m = _TAG_RE.search(s)
    if not m:
        return None, None, s
    return m.group(1), m.group(2), s[m.end():]


def parse_bbox_3d_eight_points(s: str) -> Optional[np.ndarray]:
    """Parse "[[x,y,z]x8]" back to an [8, 3] array."""
    triples = re.findall(
        r"\[\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*\]", s
    )
    if len(triples) < 8:
        return None
    return np.asarray(triples[:8], dtype=np.float64)


def parse_axis_3d(s: str) -> Optional[np.ndarray]:
    box = parse_rotated_box(s)
    if box is None or len(box) != 6:
        return None
    return np.asarray(box, dtype=np.float64).reshape(2, 3)
