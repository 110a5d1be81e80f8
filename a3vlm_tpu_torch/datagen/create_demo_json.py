"""Two-stage real-robot demo query builder (reference
data_gen/create_demo_json.py): stage 1 asks det-all-3D per image; stage 2
parses the predicted 8-point boxes from stage-1 answers and asks for the
joint type + 3D axis per predicted part."""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

from a3vlm_tpu_torch.codecs.vocab import DET_ALL_BBOX_3D_INSTRUCT

_TRIPLE_RE = re.compile(
    r"\[\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*\]"
)


def parse_boxes_from_answer(answer: str) -> list[np.ndarray]:
    """All 8-corner boxes in a det-all answer (create_demo_json.py:20-42)."""
    triples = _TRIPLE_RE.findall(answer)
    pts = np.asarray(triples, dtype=np.float64) if triples else np.zeros((0, 3))
    boxes = []
    for i in range(0, len(pts) - 7, 8):
        boxes.append(pts[i : i + 8])
    return boxes


def format_eight_point_box(points: np.ndarray) -> str:
    return (
        "["
        + ",".join("[{:.2f},{:.2f},{:.2f}]".format(*p) for p in points)
        + "]"
    )


def create_json_step1(root_dir: str) -> str:
    """(create_demo_json.py:45-61)"""
    data_dir = os.path.join(root_dir, "eval_prepare")
    tasks = []
    for item in sorted(os.listdir(data_dir)):
        image = os.path.join(data_dir, item, "color.png")
        if not os.path.exists(image):
            continue
        tasks.append(
            {
                "image": image,
                "conversations": [
                    {"from": "human", "value": DET_ALL_BBOX_3D_INSTRUCT},
                    {"from": "gpt", "value": None},
                ],
            }
        )
    out = os.path.join(root_dir, "eval_demo", "demo_det_all.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(tasks, f, indent=4)
    return out


def create_json_step2(step1_infer_result: str, demo_json_path: str) -> str:
    """(create_demo_json.py:64-112)"""
    with open(step1_infer_result) as f:
        results = json.load(f)
    # NOTE the reference uses a doubled-space prompt here (":104"):
    base_question = (
        "Please provide the joint's type and its 3D axis linked to the "
        "object part  "
    )
    tasks = []
    for res in results:
        for box in parse_boxes_from_answer(res["answer"]):
            tasks.append(
                {
                    "image": res["image"],
                    "conversations": [
                        {
                            "from": "human",
                            "value": base_question
                            + format_eight_point_box(box),
                        },
                        {"from": "gpt", "value": None},
                    ],
                }
            )
    os.makedirs(os.path.dirname(demo_json_path) or ".", exist_ok=True)
    with open(demo_json_path, "w") as f:
        json.dump(tasks, f, indent=4)
    return demo_json_path


def main(argv=None):
    p = argparse.ArgumentParser("build two-stage demo queries")
    p.add_argument("--root_dir")
    p.add_argument("--step1_results")
    p.add_argument("--step2_output")
    args = p.parse_args(argv)
    if args.root_dir:
        print("wrote", create_json_step1(args.root_dir))
    if args.step1_results and args.step2_output:
        print("wrote", create_json_step2(args.step1_results, args.step2_output))


if __name__ == "__main__":
    main()
