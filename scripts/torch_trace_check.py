"""Check the port's span recorder (``a3vlm_tpu_torch/utils/trace.py``) on
one CUDA card, on a benchmark cell's model.

    python3 scripts/torch_trace_check.py [--workload a3vlm7b-eval-rec2d] \
        [--seed 1] [--pairs 4] [--spans 200000]

Prints, as ``key: value`` lines and one JSON object last:

1. ``annotations``: whether a ``torch.profiler`` session with device
   activity only (as ``port_bench/trace.py`` runs it) sees a
   ``record_function`` range as a device event;
2. the recorder's own cost on this host: ns a span (entered and left in an
   open call) and ns a counter;
3. the cell's model (``port_bench``'s program, the seed's weights), a
   warm-up batch, then ``--pairs`` pairs of batches, one with the
   recorder as it is and one with the per-step spans (``decode.issue``,
   ``decode.wait``) made no-ops: each batch's host ms a decode step
   (``decode_ms`` over ``decode_steps``) and, with the spans, the issue
   and wait ms a step;
4. one batch under ``torch.profiler`` with host and device activity: the
   offset between each span's stamps and its ``record_function`` event,
   and each decode kernel against its step (the ``decode.issue`` span
   whose interval holds the kernel's launch, up to the next
   ``decode.wait``'s end): the share whose device interval lies outside
   its step's window, and the least gap from a launch to its kernel's
   start (negative: the device clock runs ahead of the host's)."""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def probe_annotations() -> bool:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from port_bench.trace import _device_events

    x = torch.ones(512, 512, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("probe.range"):
            (x @ x).sum()
        torch.cuda.synchronize()
    return any("probe.range" in n for n, _, _ in _device_events(prof))


def span_cost(n: int) -> dict:
    from a3vlm_tpu_torch.utils import trace

    out = {}
    with trace.call("cost"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        empty = time.perf_counter_ns() - t0
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("x"):
                pass
        out["ns_a_span"] = (time.perf_counter_ns() - t0 - empty) / n
    with trace.call("cost"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            trace.count("x")
        out["ns_a_count"] = (time.perf_counter_ns() - t0 - empty) / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="a3vlm7b-eval-rec2d")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--spans", type=int, default=200000)
    opts = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from a3vlm_tpu_torch.utils import trace
    from port_bench import core
    from port_bench.program.common import run_batch
    from port_bench.traffic.make import Traffic, render

    res = {"annotations": probe_annotations()}
    res.update(span_cost(opts.spans))
    for k, v in res.items():
        print(f"{k}: {v}", flush=True)

    spec = core.cell_spec(ROOT, opts.workload)
    cfg, mix = spec["config"], spec["traffic"]
    _, program, _ = core.family(cfg["family"])
    traffic = Traffic(mix, opts.seed, cfg["vocab_size"])
    t = cfg["towers"]

    def inputs(b):
        batch = traffic.batch(b)
        keys = batch["renders"]
        made = {k: render(opts.seed, k, mix["images"]["size"],
                          t["input_mean"], t["input_std"], "cuda",
                          torch.bfloat16) for k in set(keys)}
        return batch, torch.stack([made[k] for k in keys])

    model = program.build(cfg, opts.seed, "cuda")
    batch, images = inputs(0)
    run_batch(model, batch["prompts"], images, 2)

    real_span = trace.span

    def no_step_spans(name, device=None, **attrs):
        if name in ("decode.issue", "decode.wait"):
            return contextlib.nullcontext()
        return real_span(name, device, **attrs)

    rows = {"stamps": [], "bare": []}
    b = 0
    for _ in range(opts.pairs):
        for arm in ("stamps", "bare"):
            batch, images = inputs(b)
            b += 1
            trace.span = real_span if arm == "stamps" else no_step_spans
            try:
                _, secs, st = run_batch(model, batch["prompts"], images,
                                        traffic.new_ids)
            finally:
                trace.span = real_span
            row = {"secs": secs,
                   "step_ms": st["decode_ms"] / st["decode_steps"]}
            if arm == "stamps":
                row["issue_ms"] = st["decode_issue_ms"] / st["decode_steps"]
                row["wait_ms"] = st["decode_wait_ms"] / st["decode_steps"]
            rows[arm].append(row)
            print(f"batch {b - 1} {arm}: {json.dumps(row)}", flush=True)
    for arm, rs in rows.items():
        res[f"{arm}_step_ms_median"] = statistics.median(
            r["step_ms"] for r in rs)
    res["issue_ms_median"] = statistics.median(
        r["issue_ms"] for r in rows["stamps"])
    res["wait_ms_median"] = statistics.median(
        r["wait_ms"] for r in rows["stamps"])
    res["span_share_of_issue_pct"] = (
        100 * 2 * res["ns_a_span"] * 1e-6 / res["issue_ms_median"])

    # 4. the clock
    batch, images = inputs(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_batch(model, batch["prompts"], images, traffic.new_ids)
    rec = model.last_trace
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {}
    for e in events:
        if e.device_type() != cuda and e.name() in ("decode.issue",
                                                    "decode.wait"):
            ranges.setdefault(e.name(), []).append(e.start_ns())
    offsets = []
    for name, starts in ranges.items():
        spans = rec.named(name)
        offsets += [a - s.start_ns for a, s in zip(sorted(starts), spans)]
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != cuda
                and e.name() in ("cudaLaunchKernel", "cuLaunchKernel",
                                 "cudaLaunchKernelExC", "cuLaunchKernelEx")}
    kernels = [e for e in events if e.device_type() == cuda
               and e.correlation_id() in launches]
    issue, wait = rec.named("decode.issue"), rec.named("decode.wait")
    decode = rec.named("decode")[0]
    windows = [(s.start_ns, wait[k].end_ns if k < len(wait)
                else decode.end_ns) for k, s in enumerate(issue)]
    inside = outside = 0
    gaps = []
    for e in kernels:
        at = launches[e.correlation_id()]
        k = next((k for k, s in enumerate(issue)
                  if s.start_ns <= at <= s.end_ns), None)
        if k is None:
            continue
        lo, hi = windows[k]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        gaps.append(start - at)
        if lo <= start and end <= hi:
            inside += 1
        else:
            outside += 1
    # by time alone: a decode kernel that starts in one step's window and
    # ends past it
    starts = [lo for lo, _ in windows]
    straddle = timed = 0
    for e in events:
        if e.device_type() != cuda or not windows:
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if not windows[0][0] <= start <= windows[-1][1]:
            continue
        k = max(i for i, lo in enumerate(starts) if lo <= start)
        timed += 1
        straddle += end > windows[k][1]
    res.update({
        "device_ops_in_decode": timed,
        "straddling_a_step_end_pct": 100 * straddle / max(timed, 1),
        "host_offset_us_median": statistics.median(offsets) * 1e-3
        if offsets else None,
        "host_offset_us_max": max(offsets) * 1e-3 if offsets else None,
        "decode_kernels": inside + outside,
        "outside_their_step_pct": 100 * outside / max(inside + outside, 1),
        "launch_to_start_us_min": min(gaps) * 1e-3 if gaps else None,
        "launch_to_start_us_median": statistics.median(gaps) * 1e-3
        if gaps else None,
        "steps": len(issue) - 1,
        "card": torch.cuda.get_device_name(),
    })
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
