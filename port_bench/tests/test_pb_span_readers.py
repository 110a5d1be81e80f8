"""The readers of the program's spans and counters (``decode_issue_ms``,
``decode_wait_ms``, ``decode_useful_share``, ``convnext_ms_per_image``,
``dinov2_ms_per_image``): each on a fixed record, silent where its keys
are absent, found by name for the 7B's cell, and fed by what the program
records on a tiny run on the CPU."""

import time

import pytest
from conftest import ROOT

from port_bench import core

BATCH = {"rows": 4, "seconds": 2.0, "images_sent": 4, "decode_steps": 15,
         "decode_ms": 300.0, "decode_issue_ms": 240.0, "decode_wait_ms": 45.0,
         "row_steps_forced": 20, "row_steps_asked": 24,
         "row_steps_spare": 16, "convnext_ms": 30.0, "dinov2_ms": 8.0}
NEW = {"decode_issue_ms.ans", "decode_wait_ms.ans", "decode_useful_share.ans",
       "convnext_ms_per_image", "dinov2_ms_per_image"}
KEYS = {"decode_issue_ms.ans": "decode_issue_ms",
        "decode_wait_ms.ans": "decode_wait_ms",
        "decode_useful_share.ans": "row_steps_asked",
        "convnext_ms_per_image": "convnext_ms",
        "dinov2_ms_per_image": "dinov2_ms"}


def run(*batches):
    return {"batches": list(batches), "traced": None}


def read(name, r):
    return core.find_reader(ROOT, name)(r)


def test_values_sum_over_the_window():
    r = run(BATCH, dict(BATCH, decode_issue_ms=300.0, decode_wait_ms=15.0,
                        row_steps_asked=36, convnext_ms=50.0, dinov2_ms=12.0,
                        decode_steps=5, images_sent=12))
    assert read("decode_issue_ms.ans", r) == pytest.approx(540 / 20)
    assert read("decode_wait_ms.ans", r) == pytest.approx(60 / 20)
    assert read("decode_useful_share.ans", r) == pytest.approx(
        100 * 60 / (4 * 15 + 4 * 5))
    assert read("convnext_ms_per_image", r) == pytest.approx(80 / 16)
    assert read("dinov2_ms_per_image", r) == pytest.approx(20 / 16)


@pytest.mark.parametrize("name", sorted(NEW))
def test_silent_without_its_keys(name):
    bare = {k: v for k, v in BATCH.items() if k != KEYS[name]}
    assert read(name, run(bare)) is None
    assert read(name, run(BATCH, bare)) is None
    assert read(name, run(BATCH)) is not None


def test_towers_silent_without_images():
    r = run(dict(BATCH, images_sent=0))
    assert read("convnext_ms_per_image", r) is None
    assert read("dinov2_ms_per_image", r) is None


def test_found_by_name_for_the_cell():
    spec = core.cell_spec(ROOT, "a3vlm7b-eval-rec2d")
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert NEW <= set(layer)
    for name in NEW:
        assert layer[name]["moves"] == "answers_per_s"
        assert callable(core.find_reader(ROOT, name))


def test_fed_by_the_program(tiny_root, monkeypatch):
    """A tiny 7B run on the CPU: its batches carry every key the readers
    read, and the readers' numbers hold together (issue and wait within
    the step, the towers' parts within the towers)."""
    seen = []
    find = core.find_reader

    def keep(root, metric):
        fn = find(root, metric)
        return lambda r: (seen.append(r), fn(r))[1]

    monkeypatch.setattr(core, "find_reader", keep)
    out, _ = core.run_cell(tiny_root, "tiny-7b", 5, 0.0, False, "cpu",
                           time.perf_counter())
    assert out["correct"] and seen
    r = seen[0]
    got = {name: find(tiny_root, name)(r) for name in NEW}
    assert all(v is not None for v in got.values()), got
    step = find(tiny_root, "decode_step_ms.ans")(r)
    assert got["decode_issue_ms.ans"] + got["decode_wait_ms.ans"] <= step
    towers = find(tiny_root, "towers_ms_per_image")(r)
    assert (got["convnext_ms_per_image"] + got["dinov2_ms_per_image"]
            <= towers)
    assert 0 < got["decode_useful_share.ans"] <= 100
