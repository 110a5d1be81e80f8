"""A configuration, a traffic mix, a cell and a metric added as new files
(and entries in BENCHMARK.json), which the harness finds by name and
runs, on the CPU at a tiny size."""

import json
import time

from conftest import TINY_FALCON, write_json

from port_bench import core

READER = '''"""Rows a batch of the window (a test metric)."""


def read(run):
    b = run["batches"]
    return sum(x["rows"] for x in b) / len(b)
'''


def test_new_files_found_by_name(tiny_root):
    pb = tiny_root / "port_bench"
    write_json(pb / "configs" / "tiny-falcon-3.json",
               dict(TINY_FALCON, num_hidden_layers=3))
    write_json(pb / "traffic" / "tiny-qa.json",
               {"batch": 2, "prompt_len": [[5, 6, 1.0]], "new_ids": 3, "bos": None,
                "shared_prefix": 0, "first_id": 12, "images": None})
    write_json(pb / "workloads" / "tiny-qa.json",
               {"check": {"sample": 2, "limits": {"mean_excess": 0.02}}})
    (pb / "metrics" / "rows_per_batch.py").write_text(READER)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-falcon-3", "source": "tests",
                             "file": "port_bench/configs/tiny-falcon-3.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny-qa", "config": "tiny-falcon-3",
                               "traffic": "tiny-qa", "chips": 1,
                               "why": "tests"})
    bench["end_to_end"].append({"name": "rows_per_batch", "unit": "rows",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["tiny-qa"]})
    write_json(tiny_root / "BENCHMARK.json", bench)

    spec = core.cell_spec(tiny_root, "tiny-qa")
    assert spec["config"]["num_hidden_layers"] == 3
    assert spec["traffic"]["batch"] == 2
    assert {m["name"] for m in spec["end_to_end"]} == {"rows_per_batch",
                                                       "setup_s"}
    out, _ = core.run_cell(tiny_root, "tiny-qa", 5, 0.0, False, "cpu",
                           time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["rows_per_batch"] == {"value": 2.0,
                                                "unit": "rows"}
    assert list(out)[-1] == "check"


def test_cell_reports_only_its_metrics(tiny_root):
    e2e = {m["name"] for m in core.cell_spec(tiny_root,
                                             "tiny-7b")["end_to_end"]}
    assert e2e == {"answers_per_s", "setup_s"}
    layer = {m["name"] for m in core.cell_spec(tiny_root,
                                               "tiny-falcon")["per_layer"]}
    assert "towers_ms_per_image" not in layer
    assert "decode_step_ms.ans" in layer and "mfu.ans" in layer
