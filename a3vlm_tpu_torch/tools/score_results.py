"""Score an eval results JSON (the records eval_affordance dumps —
{answer, format_answer, annotation, question, image, fail}) with the
paper's metric families. The reference stops at dumping raw records
(eval_affordance_v2.py:386-401; scoring happened out-of-repo), so this
closes the loop: results -> per-task-type metrics in one command.

Task flavors are classified from the question text (the instruction
vocabulary of codecs/vocab.py):

- 2D rotated box (REC/joint-REC): rotated IoU, mIoU + acc@0.25/0.5,
  joint-type accuracy when <tag>'d.
- 3D bounding box: 8-corner parse; EXACT 3D OBB IoU (convex-polytope
  intersection, datagen.utils.obb_iou_3d — mIoU3d + acc@0.25/0.5, the
  paper's metric family for 3D detection) plus mean corner distance,
  center error, acc@corner-dist proxies, joint-type accuracy when tagged.
- 3D axis: endpoint L2 + direction angle error (degrees, sign-invariant).
- status: Opened/Closed string accuracy.
- detection (all parts, 2D): greedy IoU matching, precision/recall@0.5.
- detection3d (all parts, 3D 8-corner): TWO matchings — greedy by exact
  3D IoU (precision/recall@IoU 0.25) and greedy by mean corner distance
  (precision/recall at corner-dist <= 0.25, the distance proxy).

Parse-failure convention (uniform across families): a record whose answer
cannot be parsed counts as a MISS in every threshold-accuracy metric
(acc@*, precision/recall), while mean-error metrics (mIoU excepted, which
scores failures as IoU 0) are computed over the parseable subset only and
say so via the reported `n`/`parse_fail` counts.

Usage:  python -m a3vlm_tpu_torch.tools.score_results results_demo.json [...]

The port's copy of a3vlm_tpu/tools/score_results.py. One difference: a
record whose ``format_answer`` is not a string (the eval CLI writes the
repaired list of numbers there) is scored on its ``answer``, as the
original scores it with ``format_answer`` taken out; the original raises
on such a record, so its CLI's ``--score`` fails on its own results
whenever an answer holds a number.
"""

from __future__ import annotations

import argparse
import json
import math
import re

import numpy as np

from a3vlm_tpu_torch.codecs.triad import (
    parse_axis_3d,
    parse_bbox_3d_eight_points,
    parse_rotated_box,
    parse_tagged_answer,
)
from a3vlm_tpu_torch.datagen.utils import obb_iou_3d, rotated_box_iou


def classify(question: str) -> str:
    q = question.lower()
    if "status" in q or "opened or closed" in q:
        return "status"
    if "axis" in q:
        return "axis"
    if "all manipulable" in q or "detect all" in q:
        # DET_ALL_BBOX_3D_INSTRUCT shares the "all manipulable" prefix with
        # the 2D variants — route it to its own 3D family, not _boxes2d
        return "detection3d" if "3d" in q else "detection"
    if "3d" in q:
        return "box3d"
    return "box2d"


def _boxes2d(text: str) -> list[list[float]]:
    out = []
    for part in text.split("]"):
        b = parse_rotated_box(part + "]")
        if b is not None:
            out.append(b)
    return out


_TRIPLE_RE = re.compile(
    r"\[\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*\]"
)


def _boxes3d(text: str) -> list[np.ndarray]:
    """All 8-corner boxes in a det-all-3D answer: every box is exactly 8
    consecutive [x,y,z] triples, so chunk the triple stream by 8 (the
    6-float non-eight-points encoding has no [x,y,z] groups and parses to
    zero boxes -> counted as a parse failure by the caller). Model output
    is arbitrary text: a regex hit that still fails float conversion
    (e.g. "0.1.2") drops that box instead of crashing the CLI."""
    triples = _TRIPLE_RE.findall(text)
    boxes = []
    for i in range(0, len(triples) - 7, 8):
        try:
            boxes.append(np.asarray(triples[i : i + 8], dtype=np.float64))
        except ValueError:
            continue
    return boxes


def _iou2d(a, b) -> float:
    def to_px(x):
        return (x[0] * 100, x[1] * 100, x[2] * 100, x[3] * 100,
                math.degrees(x[4]))

    try:
        return float(rotated_box_iou(to_px(a), to_px(b)))
    except Exception:
        return 0.0


def score_records(records: list[dict]) -> dict:
    acc: dict[str, dict] = {}

    def bucket(kind):
        return acc.setdefault(
            kind,
            {"n": 0, "iou": [], "iou3d": [], "type_ok": [],
             "corner_dist": [], "center_err": [], "angle_err": [],
             "endpoint_err": [], "status_ok": [], "tp": 0, "fp": 0,
             "fn": 0, "tp_iou": 0, "fp_iou": 0, "fn_iou": 0,
             "parse_fail": 0},
        )

    for r in records:
        kind = classify(r.get("question", ""))
        b = bucket(kind)
        b["n"] += 1
        # the eval CLI's records carry format_answer as the repaired list
        # of numbers; only a string one is a parseable answer (the
        # original takes the list and fails on it)
        fa = r.get("format_answer")
        ans = (fa if isinstance(fa, str) and fa else None) or r.get(
            "answer") or ""
        gt = r.get("annotation") or ""
        if kind == "status":
            pa = "opened" if "open" in ans.lower() else (
                "closed" if "close" in ans.lower() else "?")
            ga = "opened" if "open" in gt.lower() else (
                "closed" if "close" in gt.lower() else "?")
            b["status_ok"].append(pa == ga and pa != "?")
            continue
        if kind == "axis":
            pa, ga = parse_axis_3d(ans), parse_axis_3d(gt)
            dp = None if pa is None else pa[1] - pa[0]
            dg = None if ga is None else ga[1] - ga[0]
            denom = (
                0.0 if pa is None or ga is None
                else np.linalg.norm(dp) * np.linalg.norm(dg)
            )
            if denom < 1e-9:
                # unparseable OR degenerate direction: one parse_fail,
                # contributes to NO mean metric (misses are charged in the
                # acc_* denominators at summary time)
                b["parse_fail"] += 1
                continue
            b["endpoint_err"].append(
                float(np.linalg.norm(pa - ga, axis=-1).mean())
            )
            cos = abs(float(np.dot(dp, dg) / denom))
            b["angle_err"].append(math.degrees(math.acos(min(cos, 1.0))))
            continue
        if kind == "box3d":
            _, ptype, ans_s = parse_tagged_answer(ans)
            _, gtype, gt_s = parse_tagged_answer(gt)
            if ptype is not None or gtype is not None:
                b["type_ok"].append(ptype == gtype)
            pa = parse_bbox_3d_eight_points(ans_s)
            ga = parse_bbox_3d_eight_points(gt_s)
            if pa is None or ga is None:
                b["parse_fail"] += 1
                continue
            b["corner_dist"].append(
                float(np.linalg.norm(pa - ga, axis=-1).mean())
            )
            b["center_err"].append(
                float(np.linalg.norm(pa.mean(0) - ga.mean(0)))
            )
            b["iou3d"].append(obb_iou_3d(pa, ga))
            continue
        if kind == "detection3d":
            pb, gb = _boxes3d(ans), _boxes3d(gt)
            if not gb or (not pb and ans.strip()):
                b["parse_fail"] += 1
            matched = set()
            for p in pb:
                best, best_j = math.inf, -1
                for j, g in enumerate(gb):
                    if j in matched:
                        continue
                    d = float(np.linalg.norm(p - g, axis=-1).mean())
                    if d < best:
                        best, best_j = d, j
                if best <= 0.25:
                    matched.add(best_j)
                    b["tp"] += 1
                else:
                    b["fp"] += 1
            b["fn"] += len(gb) - len(matched)
            # second matching by EXACT 3D IoU (the paper's criterion);
            # half-spaces + own volumes prepped once per box, not per pair
            from a3vlm_tpu_torch.datagen.utils import obb_iou_3d_prepped, obb_prep

            pps = [obb_prep(p) for p in pb]
            gps = [obb_prep(g) for g in gb]
            matched = set()
            for pp in pps:
                best, best_j = 0.0, -1
                for j, gp in enumerate(gps):
                    if j in matched:
                        continue
                    i3 = obb_iou_3d_prepped(pp, gp)
                    if i3 > best:
                        best, best_j = i3, j
                if best >= 0.25:
                    matched.add(best_j)
                    b["tp_iou"] += 1
                else:
                    b["fp_iou"] += 1
            b["fn_iou"] += len(gb) - len(matched)
            continue
        if kind == "detection":
            pb, gb = _boxes2d(ans), _boxes2d(gt)
            matched = set()
            for p in pb:
                best, best_j = 0.0, -1
                for j, g in enumerate(gb):
                    if j in matched:
                        continue
                    i = _iou2d(p, g)
                    if i > best:
                        best, best_j = i, j
                if best >= 0.5:
                    matched.add(best_j)
                    b["tp"] += 1
                else:
                    b["fp"] += 1
            b["fn"] += len(gb) - len(matched)
            continue
        # box2d REC (possibly tagged with the joint type)
        _, ptype, ans_s = parse_tagged_answer(ans)
        _, gtype, gt_s = parse_tagged_answer(gt)
        if ptype is not None or gtype is not None:
            b["type_ok"].append(ptype == gtype)
        pa, ga = parse_rotated_box(ans_s), parse_rotated_box(gt_s)
        if pa is None or ga is None:
            b["parse_fail"] += 1
            b["iou"].append(0.0)
            continue
        b["iou"].append(_iou2d(pa, ga))

    out = {}
    for kind, b in acc.items():
        row: dict = {"n": b["n"], "parse_fail": b["parse_fail"]}
        if b["iou"]:
            ious = np.asarray(b["iou"])
            row.update(
                miou=round(float(ious.mean()), 4),
                acc_at_25=round(float((ious >= 0.25).mean()), 4),
                acc_at_50=round(float((ious >= 0.5).mean()), 4),
            )
        if b["type_ok"]:
            row["joint_type_acc"] = round(float(np.mean(b["type_ok"])), 4)
        if b["corner_dist"] or (kind == "box3d" and b["parse_fail"]):
            cd = np.asarray(b["corner_dist"], dtype=np.float64)
            scored = len(cd) + b["parse_fail"]  # failures are misses
            row["acc_corner_at_0p25"] = round(
                float((cd <= 0.25).sum()) / max(scored, 1), 4
            )
            i3 = np.asarray(b["iou3d"], dtype=np.float64)
            row["acc_iou3d_at_25"] = round(
                float((i3 >= 0.25).sum()) / max(scored, 1), 4
            )
            row["acc_iou3d_at_50"] = round(
                float((i3 >= 0.5).sum()) / max(scored, 1), 4
            )
            if len(cd):
                row.update(
                    mean_corner_dist=round(float(cd.mean()), 4),
                    mean_center_err=round(
                        float(np.mean(b["center_err"])), 4
                    ),
                    miou3d=round(float(i3.mean()), 4),
                )
        if b["angle_err"] or (kind == "axis" and b["parse_fail"]):
            ae = np.asarray(b["angle_err"], dtype=np.float64)
            scored = len(ae) + b["parse_fail"]  # failures are misses
            row["acc_axis_at_10deg"] = round(
                float((ae <= 10.0).sum()) / max(scored, 1), 4
            )
            if len(ae):
                row.update(
                    mean_axis_angle_deg=round(float(ae.mean()), 2),
                    mean_endpoint_err=round(
                        float(np.mean(b["endpoint_err"])), 4
                    ),
                )
        if b["status_ok"]:
            row["status_acc"] = round(float(np.mean(b["status_ok"])), 4)
        if b["tp"] + b["fp"] + b["fn"] > 0:
            p = b["tp"] / max(b["tp"] + b["fp"], 1)
            r_ = b["tp"] / max(b["tp"] + b["fn"], 1)
            # match criterion differs by family: 2D IoU>=0.5, 3D mean
            # corner distance <= 0.25 — name the keys accordingly
            suffix = "_cd0p25" if kind == "detection3d" else "_at_50"
            row.update({
                "precision" + suffix: round(p, 4),
                "recall" + suffix: round(r_, 4),
                "f1" + suffix: round(2 * p * r_ / max(p + r_, 1e-9), 4),
            })
        if b["tp_iou"] + b["fp_iou"] + b["fn_iou"] > 0:
            p = b["tp_iou"] / max(b["tp_iou"] + b["fp_iou"], 1)
            r_ = b["tp_iou"] / max(b["tp_iou"] + b["fn_iou"], 1)
            row.update({
                "precision_iou0p25": round(p, 4),
                "recall_iou0p25": round(r_, 4),
                "f1_iou0p25": round(2 * p * r_ / max(p + r_, 1e-9), 4),
            })
        out[kind] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("score eval results JSON")
    ap.add_argument("results", nargs="+")
    ap.add_argument("--out", default=None, help="write summary JSON here")
    a = ap.parse_args(argv)
    records = []
    for f in a.results:
        with open(f) as fh:
            records.extend(json.load(fh))
    summary = score_records(records)
    text = json.dumps(summary, indent=2, sort_keys=True)
    print(text)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(text)
    return summary


if __name__ == "__main__":
    main()
