"""BENCHMARK.json against the benchmark's contract: its keys and limits,
and every file it names (configuration, mix, cell file, reader)."""

import json
import re

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check of 24 cells fits its 43200 s
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180
            + 1200) <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("port_bench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank", "_size"))


def test_workloads():
    cells = BENCH["workloads"]
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells) == len({w["name"] for w in cells})
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (ROOT / "port_bench" / "traffic"
                / f"{w['traffic']}.json").exists()
        cell = json.loads((ROOT / "port_bench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert cell["check"]["sample"] >= 1 and cell["check"]["limits"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    from port_bench.core import find_reader

    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        find_reader(ROOT, m["name"])
        if kind == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert line(m["layer"]) and m["moves"] in e2e
            moved = e2e[m["moves"]].get("workloads", cells)
            assert set(m["workloads"]) <= set(moved)
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        n = w["name"]
        e2e = [m for m in BENCH["end_to_end"]
               if n in m.get("workloads", [n])]
        layer = [m for m in BENCH["per_layer"]
                 if n in m.get("workloads", [n])]
        assert len(e2e) >= 2 and layer
        assert any("mfu" in m["name"] for m in layer)
