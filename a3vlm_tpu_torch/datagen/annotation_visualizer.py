"""QA visualization of produced VQA tasks (reference
data_gen/annotation_visualizer.py): parses the task answer strings back
(8-point 3D boxes, axis endpoints, 2D rotated boxes) and draws overlays onto
the source images with cv2 (matplotlib-free)."""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np

from a3vlm_tpu_torch.codecs.triad import (
    parse_axis_3d,
    parse_bbox_3d_eight_points,
    parse_rotated_box,
    parse_tagged_answer,
    unnormalize_val,
)

# 3D box edge list in the reference corner order (partnet_label.py:163-175)
BOX_EDGES = [
    (0, 1), (0, 2), (0, 3), (1, 6), (1, 7), (2, 7), (2, 5), (6, 4), (5, 4),
    (4, 7), (3, 6), (3, 5),
]


def _to_px(points01, width, height):
    return np.stack(
        [points01[:, 0] * width, points01[:, 1] * height], axis=1
    ).astype(np.int32)


def visualize_joint_3d(image, answer: str, normalized: bool = True):
    """Draw a parsed ``<axis>type</axis>[x0,y0,z0,x1,y1,z1]`` answer."""
    import cv2

    h, w = image.shape[:2]
    tag, label, rest = parse_tagged_answer(answer)
    axis = parse_axis_3d(rest if tag else answer)
    if axis is None:
        return image
    if normalized:
        axis = unnormalize_val(axis, 0.0, 1.0, 100.0)
    px = _to_px(axis, w, h)
    cv2.arrowedLine(image, tuple(px[0]), tuple(px[1]), (0, 200, 200), 3)
    if label:
        cv2.putText(image, label, tuple(px[0]), cv2.FONT_HERSHEY_SIMPLEX, 1,
                    (0, 200, 200), 2)
    return image


def visualize_box_3d(image, answer: str, normalized: bool = True,
                     color=(0, 255, 0)):
    """Draw an 8-point projected 3D box answer."""
    import cv2

    h, w = image.shape[:2]
    pts = parse_bbox_3d_eight_points(answer)
    if pts is None:
        return image
    if normalized:
        pts = unnormalize_val(pts, 0.0, 1.0, 100.0)
    px = _to_px(pts, w, h)
    for a, b in BOX_EDGES:
        cv2.line(image, tuple(px[a]), tuple(px[b]), color, 2)
    return image


def visualize_rotated_box_2d(image, answer: str, color=(255, 0, 0)):
    """Draw a normalized ``[cx,cy,w,h,angle]`` answer."""
    import cv2

    h, w = image.shape[:2]
    box = parse_rotated_box(answer)
    if box is None or len(box) < 5:
        return image
    cx, cy, bw, bh, angle = box[:5]
    rect = cv2.boxPoints(
        ((cx * w, cy * h), (bw * w, bh * h), angle * 180 / np.pi)
    ).astype(np.int32)
    cv2.drawContours(image, [rect], 0, color, 2)
    return image


def visualize_task_file(task_json: str, out_dir: str, sample_num: int = 20,
                        seed: int = 0):
    import cv2

    with open(task_json) as f:
        tasks = json.load(f)
    random.seed(seed)
    tasks = random.sample(tasks, min(sample_num, len(tasks)))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, task in enumerate(tasks):
        img = cv2.imread(task["image"])
        if img is None:
            continue
        answer = task["conversations"][1]["value"]
        if "<axis>" in answer:
            img = visualize_joint_3d(img, answer)
        elif "[[" in answer or "<box>" in answer:
            img = visualize_box_3d(img, answer)
        elif "[" in answer:
            img = visualize_rotated_box_2d(img, answer)
        out = os.path.join(out_dir, f"{i}_vis.jpg")
        cv2.imwrite(out, img)
        written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser("visualize VQA task annotations")
    p.add_argument("--task_json", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sample_num", type=int, default=20)
    args = p.parse_args(argv)
    written = visualize_task_file(args.task_json, args.out_dir,
                                  args.sample_num)
    print(f"wrote {len(written)} visualizations to {args.out_dir}")


if __name__ == "__main__":
    main()
