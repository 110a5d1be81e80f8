"""A device trace of one call: ``torch.profiler`` with device activity
only, its events read in memory. Gives every device operation's interval
(kernels, copies, fills), their union (the busy time), the time by
kernel, and the idle gaps between operations, each named by the two
operations around it."""

from __future__ import annotations

import re
import time
from collections import defaultdict

import torch


def short_name(name: str) -> str:
    """A kernel's name without its return type, its argument list and the
    namespaces outside its template arguments; the template arguments
    kept (``gemv_cluster_kernel<0, 4>``), 96 characters at most."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = re.sub(r"^void ", "", name)
    depth, start = 0, 0
    for i, c in enumerate(name):
        depth += {"<": 1, ">": -1}.get(c, 0)
        if depth == 0 and name.startswith("::", i):
            start = i + 2
    return name[start:][:96].strip()


def _device_events(prof):
    """(name, start s, end s) of every device event."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        return [(e.name(), e.start_ns() * 1e-9,
                 (e.start_ns() + e.duration_ns()) * 1e-9)
                for e in raw if e.device_type() == cuda]
    return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            for e in prof.events() if e.device_type == cuda]


def traced_call(fn):
    """``fn()`` under the profiler: (its result, the trace summary). The
    window is the host's clock around the call, synchronised."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return out, summarize(_device_events(prof), window)


def summarize(events, window_s: float) -> dict:
    """``busy_s`` (the union of the events' intervals), ``window_s``,
    ``kernels`` {short name: [seconds, launches]}, ``gaps`` {"a -> b":
    seconds} of the idle time between one operation's end and the next
    one's start."""
    kernels = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        k = kernels[short_name(name)]
        k[0] += e - s
        k[1] += 1
    busy, gaps = 0.0, defaultdict(float)
    cur_s = cur_e = None
    last = None
    for name, s, e in sorted(events, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps[f"{short_name(last)} -> {short_name(name)}"] += s - cur_e
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
        if e >= cur_e:
            last = name
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"busy_s": busy, "window_s": window_s, "events": len(events),
            "kernels": dict(kernels), "gaps": dict(gaps)}


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def route_seconds(summary: dict, prefix: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose short name starts
    with ``prefix``."""
    sel = [v for k, v in summary["kernels"].items() if k.startswith(prefix)]
    return sum(v[0] for v in sel), sum(v[1] for v in sel)
