"""The harness: one cell, one seed, one run.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration file it names, ``traffic/<mix>.json``,
``workloads/<cell>.json`` (the sample the check compares and each
number's limit), and one reader a metric, ``metrics/<metric>.py``
(``metrics/<part before the first dot>.py`` where the suffix only names
the end-to-end metric it moves). The configuration's ``family`` names
the modules of its sizes and weights (``arch/``), of the program under
test (``program/``) and of its plain reference (``reference/``).

A run: build the program from the seed's weights; warm up with the first
batch at 2 new ids; then the window, whole static batches back to back
until ``seconds`` have passed (a batch still running then counts in
neither the work nor the time; the first batch always counts); with
``trace`` one more batch under the profiler; the peak memory; then, with
the program freed, the check against the reference."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from port_bench import check
from port_bench.program.common import run_batch
from port_bench.traffic.make import Traffic, render

FORBIDDEN = ("jax", "jaxlib", "flax", "a3vlm_tpu")
PB = "port_bench"
WARMUP_NEW_IDS = 2


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: Path, cell: str) -> dict:
    """The cell's entry, its configuration, mix, cell file and the
    metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m, e2e_names=None):
        if "workloads" in m:
            return cell in m["workloads"]
        return e2e_names is None or m["moves"] in e2e_names

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    return {
        "name": cell, "entry": w,
        "config": load_json(root / conf["file"]),
        "traffic": load_json(root / PB / "traffic" / f"{w['traffic']}.json"),
        "cell": load_json(root / PB / "workloads" / f"{cell}.json"),
        "end_to_end": e2e,
        "per_layer": [m for m in bench["per_layer"] if applies(m, names)],
    }


def family(name: str):
    """(arch, program, reference) modules of a configuration's family."""
    return tuple(importlib.import_module(f"port_bench.{part}.{name}")
                 for part in ("arch", "program", "reference"))


def find_reader(root: Path, metric: str):
    """The ``read(run)`` function of a metric's reader file."""
    base = root / PB / "metrics"
    for stem in (metric, metric.split(".")[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"port_bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under {base}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> tuple:
    """One run of ``cell``: (the result line as a dict, ``check`` last;
    every number the check worked out). ``control`` builds the program
    with its int8-activation paths on (the check's control; never in a
    benchmark run)."""
    spec = cell_spec(root, cell)
    cfg, mix = spec["config"], spec["traffic"]
    arch, program, reference = family(cfg["family"])
    traffic = Traffic(mix, seed, cfg["vocab_size"])
    dtype = getattr(torch, cfg.get("dtype", "bfloat16"))

    def renders(keys) -> dict:
        t = cfg["towers"]
        return {k: render(seed, k, mix["images"]["size"], t["input_mean"],
                          t["input_std"], device, dtype) for k in keys}

    def inputs(b):
        """Batch ``b`` and its images, a render sent once a question."""
        batch = traffic.batch(b)
        keys = batch["renders"]
        if keys is None:
            return batch, None
        made = renders(set(keys))
        return batch, torch.stack([made[k] for k in keys])

    def record(batch, outs, secs, stats) -> dict:
        prompts, keys = batch["prompts"], batch["renders"]
        return {"prompts": prompts, "outs": outs, "renders": keys,
                "seconds": secs, "rows": len(prompts),
                "gen_ids": sum(len(o) for o in outs),
                "prompt_lens": [len(p) for p in prompts],
                "gen_lens": [len(o) for o in outs],
                "images_sent": len(keys) if keys else 0,
                "distinct_images": len(set(keys)) if keys else 0,
                # the ids the prefill took: the rest of the longest
                # prompt and every new id but the last cost a step each
                "bucket": max(len(p) for p in prompts) + traffic.new_ids
                - 1 - stats["decode_steps"],
                "image_words": arch.image_words(cfg) if keys else 0,
                "failed": check.malformed(prompts, outs, traffic.new_ids,
                                          cfg["vocab_size"]),
                **stats}

    model = program.build(cfg, seed, device, control)
    batch, images = inputs(0)
    run_batch(model, batch["prompts"], images, WARMUP_NEW_IDS)
    del images
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    log(f"set-up {setup_s:.3f} s")

    batches, b = [], 0
    while True:
        batch, images = inputs(b)
        if batches and time.perf_counter() - t_window >= seconds:
            break
        outs, secs, stats = run_batch(model, batch["prompts"],
                                              images, traffic.new_ids)
        over = time.perf_counter() - t_window > seconds
        log(f"batch {b}: {secs:.4f} s {'(past the window) ' if over else ''}"
            + json.dumps({k: round(v, 3) for k, v in stats.items()}))
        if over and batches:
            break
        batches.append(record(batch, outs, secs, stats))
        b += 1

    traced = None
    if trace:
        from port_bench.trace import traced_call

        batch, images = inputs(b)
        (outs, secs, stats), summary = traced_call(
            lambda: run_batch(model, batch["prompts"], images,
                                      traffic.new_ids))
        traced = record(batch, outs, secs, stats)
        traced["trace"] = summary
        log(f"traced batch {b}: {secs:.4f} s, {summary['events']} device "
            f"events, busy {summary['busy_s']:.4f} s")
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, images
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check, with the program's state freed
    t_check = time.perf_counter()
    requests = [{"prompt": p, "served": o, "image": k}
                for rec in batches for p, o, k in zip(
                    rec["prompts"], rec["outs"],
                    rec["renders"] or [None] * rec["rows"]) if o]
    picked = check.sample(requests, spec["cell"]["check"]["sample"], seed)
    keys = {r["image"] for r in picked if r["image"] is not None}
    logits = reference.served_logits(cfg, seed, picked, renders(keys)
                                     if keys else {}, device)
    gaps, best = check.gaps(logits, picked)
    found = check.numbers(gaps, best)
    ok, shown = check.judge(found, spec["cell"]["check"]["limits"])
    failed = sum(rec["failed"] for rec in batches)
    log(f"check: {len(picked)} requests, {gaps.numel()} served ids, "
        f"{float((gaps > 0).double().mean()):.4f} of them not the "
        f"reference's best, {time.perf_counter() - t_check:.3f} s; "
        + json.dumps(found))

    run = {"cfg": cfg, "arch": arch, "batches": batches, "traced": traced,
           "setup_s": setup_s, "peak_bytes": peak}
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = find_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec["entry"]["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(ok and failed == 0 and batches),
           "attempted": sum(rec["rows"] for rec in batches),
           "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        from port_bench.trace import breakdown

        dev["busy_s"] = traced["trace"]["busy_s"]
        dev["window_s"] = traced["trace"]["window_s"]
        out["breakdown"] = breakdown(traced["trace"])
    out["check"] = shown
    return out, found
