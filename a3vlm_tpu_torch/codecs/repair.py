"""Eval-side tolerant answer repair (reference eval_affordance_v2.py:206-232,
344-357): digit-string cleanup, decimal-point re-insertion into >=4-digit
runs, magnitude renormalization, and the '###' / "answer is" extraction."""

from __future__ import annotations

import re


def normalize_number(x: float) -> float:
    """(eval_affordance_v2.py:206-214)"""
    if x > 100:
        return x / 1000
    elif x > 10:
        return x / 100
    elif x >= 1:
        return x / 10
    return x


def format_bounding_box(answer: str) -> list[float]:
    """(eval_affordance_v2.py:216-232)"""
    cleaned = re.sub(r"[^\d,]", "", answer.replace(" ", ""))

    def insert_dot(match):
        number = match.group(0)
        return number[:-3] + "." + number[-3:]

    formatted = re.sub(r"\d{4,}", insert_dot, cleaned)
    bbox = [float(n) for n in formatted.split(",") if n]
    return [normalize_number(x) for x in bbox]


def extract_answer(raw: str) -> str:
    """'###'-split + "answer is" extraction (eval_affordance_v2.py:344-357)."""
    answer = raw.split("###")[0]
    answer = answer.replace(".", "").strip()
    if len(answer.strip().split(" ")) > 0:
        for a_p in ["answer is"]:
            if a_p in answer:
                try:
                    extracted = re.findall(f"{a_p}[ ]*[a-zA-Z0-9.]+", answer)[0]
                    extracted = re.sub(a_p, "", extracted)
                    answer = extracted.strip()
                except Exception:
                    answer = answer.strip()
    return answer


def check_box_failed(dt_bbox: list[float]) -> bool:
    """Failure flagging: len != 4 or inverted box
    (eval_affordance_v2.py:359-364)."""
    if len(dt_bbox) != 4:
        return True
    return dt_bbox[0] > dt_bbox[2] or dt_bbox[1] > dt_bbox[3]
