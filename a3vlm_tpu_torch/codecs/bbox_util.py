"""2D box formatting utilities — the live surface of reference
model/accessory/data/bbox_util.py (:34-257, :1100-1104; the ~800 commented
lines are dead code and not carried over):

- Expand2square padding with box adjustment
- BoxFormatProcess + PlainBoxFormatter: normalize boxes to 3 decimals,
  substitute <boxes>/<points> placeholders, extract box groups back out
- denorm_bboxes
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

BOXES_PLACEHOLDER = "<boxes>"
POINTS_PLACEHOLDER = "<points>"


def expand2square_offsets(width: int, height: int) -> tuple[int, int, int]:
    """(pad_x, pad_y, side) used to adjust boxes after square padding
    (bbox_util.py:34-81 Expand2square)."""
    side = max(width, height)
    return (side - width) // 2, (side - height) // 2, side


def adjust_box_for_expand2square(box, width: int, height: int):
    px, py, side = expand2square_offsets(width, height)
    x1, y1, x2, y2 = box
    return (x1 + px, y1 + py, x2 + px, y2 + py)


class PlainBoxFormatter:
    """(bbox_util.py:~190-257): "(x1,y1,x2,y2)" triples-of-3-decimals with
    ";"-separated multi-box groups, plus regex extraction."""

    def __init__(self, precision: int = 3, use_small_brackets: bool = False):
        self.precision = precision
        self.use_small_brackets = use_small_brackets
        small = r"\(\d(?:\.\d*)?(?:,\d(?:\.\d*)?){3}(?:;\d(?:\.\d*)?(?:,\d(?:\.\d*)?){3})*\)"
        square = r"\[\d(?:\.\d*)?(?:,\d(?:\.\d*)?){3}(?:;\d(?:\.\d*)?(?:,\d(?:\.\d*)?){3})*\]"
        self.pat = re.compile(small if use_small_brackets else square)

    def format_box(self, boxes: List[List[float]]) -> str:
        strs = [
            ",".join(f"{x:.{self.precision}f}" for x in box) for box in boxes
        ]
        joined = ";".join(strs)
        return f"({joined})" if self.use_small_brackets else f"[{joined}]"

    format_point = format_box

    def __call__(self, sentence: str, bboxes_seq) -> str:
        all_box = re.findall(re.escape(BOXES_PLACEHOLDER), sentence)
        assert len(all_box) == len(bboxes_seq), (sentence, bboxes_seq)
        if not all_box:
            return sentence
        strs = [self.format_box(b) for b in bboxes_seq]
        return sentence.replace(BOXES_PLACEHOLDER, "{}").format(*strs)

    def call_on_point(self, sentence: str, points_seq) -> str:
        all_pt = re.findall(re.escape(POINTS_PLACEHOLDER), sentence)
        assert len(all_pt) == len(points_seq)
        if not all_pt:
            return sentence
        strs = [self.format_point(p) for p in points_seq]
        return sentence.replace(POINTS_PLACEHOLDER, "{}").format(*strs)

    def extract(self, string: str) -> List[List[List[float]]]:
        """All box groups in a string (bbox_util.py extract)."""
        out = []
        for match in self.pat.findall(string):
            groups = match[1:-1].split(";")
            out.append(
                [[float(x) for x in g.split(",")] for g in groups]
            )
        return out


class BoxFormatProcess:
    """(bbox_util.py:84-165): normalize target boxes/points and substitute
    the placeholders in a conversation sentence."""

    def __init__(self, box_formatter: PlainBoxFormatter):
        self.box_formatter = box_formatter

    @staticmethod
    def map_obj(values, seq):
        ret = []
        for group in seq:
            group_ret = []
            for idx in group:
                if isinstance(idx, (list, tuple)):
                    group_ret.append(values[idx[0]][idx[1]])
                else:
                    group_ret.append(values[idx])
            ret.append(group_ret)
        return ret

    @staticmethod
    def norm_box_xyxy(box, *, w, h):
        x1, y1, x2, y2 = box
        return (
            round(max(0.0, min(x1 / w, 1.0)), 3),
            round(max(0.0, min(y1 / h, 1.0)), 3),
            round(max(0.0, min(x2 / w, 1.0)), 3),
            round(max(0.0, min(y2 / h, 1.0)), 3),
        )

    @staticmethod
    def norm_point_xyxy(point, *, w, h):
        x, y = point
        return (max(0.0, min(x / w, 1.0)), max(0.0, min(y / h, 1.0)))

    def __call__(
        self, sentence: Dict[str, Any], target: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        normalized_boxes = [
            self.norm_box_xyxy(b, w=target["width"], h=target["height"])
            for b in (target or {}).get("boxes", [])
        ]
        normalized_points = [
            self.norm_point_xyxy(p, w=target["width"], h=target["height"])
            for p in (target or {}).get("points", [])
        ]
        words = sentence["value"]
        changed = False
        if sentence.get("boxes_seq") is not None:
            seq = self.map_obj(normalized_boxes, sentence["boxes_seq"])
            words = self.box_formatter(words, seq)
            changed = True
        if sentence.get("points_seq") is not None:
            seq = self.map_obj(normalized_points, sentence["points_seq"])
            words = self.box_formatter.call_on_point(words, seq)
            changed = True
        if changed:
            sentence["raw_value"] = sentence["value"]
            sentence["value"] = words
        return sentence, target


def denorm_bboxes(w: int, h: int, box):
    """(bbox_util.py:1100-1104)"""
    xmin, ymin, xmax, ymax = box
    return [xmin * w, ymin * h, xmax * w, ymax * h]
