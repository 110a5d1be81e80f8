"""The port's spans and counters: one record a call, always on.

A *call* is one top-level operation (``MetaModel.generate_tokens``, or a
``Generator`` used alone), opened with ``call(name)``. Inside it,
``span(name, **attrs)`` records ``(name, start_ns, end_ns, parent,
attrs)`` and ``count(name, n)`` adds to the call's counters. The caller
keeps the record of its last call (``MetaModel.last_trace``), in memory;
nothing is written anywhere.

- **Clock.** Stamps are nanoseconds on ``torch.profiler``'s clock
  (``CLOCK_REALTIME``): ``perf_counter_ns`` plus one offset taken when the
  call opens, so a span and the profiler's events of the same call lie on
  one timeline.
- **Profiler.** While a ``torch.profiler`` session is on, a span also opens
  ``torch.profiler.record_function(name)``; outside a call that is all a
  span does (the mesh's collectives in training).
- **Device time.** ``span(name, device=d)`` with ``d`` a CUDA device also
  records a CUDA-event pair on its current stream; the call reads its
  milliseconds when it closes, after the caller's own final
  synchronisation (an event not yet reached reads None; nothing waits).
  On another device the device ms are the host ms.
- **Threads.** The open call is the thread's own.

``Record.stats()`` turns a record into the numbers of ``last_stats``."""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import torch

_now = time.perf_counter_ns
_ids = itertools.count(1)
_local = threading.local()

# last_stats key <- (span name, how): "host" the ms of the one span of
# that name, "sum" the host ms of every span of it, "device" the device ms
STATS = (("towers_ms", "towers", "host"),
         ("prefill_ms", "prefill", "host"),
         ("decode_ms", "decode", "host"),
         ("decode_issue_ms", "decode.issue", "sum"),
         ("decode_wait_ms", "decode.wait", "sum"),
         ("convnext_ms", "towers.convnext", "device"),
         ("dinov2_ms", "towers.dinov2", "device"))


class Span:
    """One recorded interval; ``parent`` is the index of the enclosing
    span in the record (-1 for the call's root)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs",
                 "device_ms", "_events")

    def __init__(self, name, start_ns, parent, attrs):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = start_ns
        self.parent = parent
        self.attrs = attrs
        self.device_ms: Optional[float] = None
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Record:
    """The spans (in opening order) and counters of one call."""

    def __init__(self):
        self.call_id = next(_ids)
        self.spans: list[Span] = []
        self.counters: dict = {}
        # perf_counter_ns -> the profiler's clock
        self.offset_ns = time.time_ns() - _now()

    def stats(self, first: int = 0) -> dict:
        """The ``last_stats`` numbers of spans ``first`` onwards (``STATS``;
        a key only where its span was recorded) and the counters."""
        out = {}
        spans = self.spans[first:]
        for key, name, how in STATS:
            sel = [s for s in spans if s.name == name]
            if not sel:
                continue
            if how == "host":
                out[key] = sel[0].host_ms
            elif how == "sum":
                out[key] = sum(s.host_ms for s in sel)
            else:
                dev = [s.device_ms for s in sel]
                if None in dev:
                    continue
                out[key] = sum(dev)
        out.update(self.counters)
        return out

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def _close(self) -> None:
        for s in self.spans:
            if s._events is None:
                continue
            start, end = s._events
            s._events = None
            if end.query():
                s.device_ms = start.elapsed_time(end)


class _SpanCtx:
    __slots__ = ("name", "attrs", "device", "rec", "span", "prev", "rf")

    def __init__(self, name, device, attrs):
        self.name = name
        self.device = device
        self.attrs = attrs

    # the stamps bracket the profiler's range: its event lies inside them
    def __enter__(self) -> Optional[Span]:
        rec = self.rec = getattr(_local, "rec", None)
        s = self.span = None
        if rec is not None:
            self.prev = _local.open
            s = self.span = Span(self.name, _now() + rec.offset_ns,
                                 self.prev, self.attrs)
            _local.open = len(rec.spans)
            rec.spans.append(s)
            if self.device is not None and self.device.type == "cuda":
                s._events = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                s._events[0].record(torch.cuda.current_stream(self.device))
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return s

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        s = self.span
        if s is not None:
            if s._events is not None:
                s._events[1].record(torch.cuda.current_stream(self.device))
            s.end_ns = _now() + self.rec.offset_ns
            if self.device is not None and s._events is None:
                s.device_ms = s.host_ms
            _local.open = self.prev


def span(name: str, device: Optional[torch.device] = None,
         **attrs) -> _SpanCtx:
    """A context manager recording ``name`` into the open call (see the
    module's docstring); ``device``: the device whose time to take too."""
    return _SpanCtx(name, device, attrs)


class _CallCtx:
    __slots__ = ("name", "root", "span")

    def __init__(self, name):
        self.name = name

    def __enter__(self) -> Record:
        rec = getattr(_local, "rec", None)
        self.root = rec is None
        if self.root:
            rec = _local.rec = Record()
            _local.open = -1
            self.span = span(self.name)
            self.span.__enter__()
        return rec

    def __exit__(self, *exc) -> None:
        if not self.root:
            return
        self.span.__exit__(*exc)
        rec = _local.rec
        _local.rec = None
        rec._close()


def call(name: str) -> _CallCtx:
    """Open a call whose root span is ``name`` and yield its ``Record``; in
    a thread that has a call open already, yield that one (no new span)."""
    return _CallCtx(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open call's counter ``name`` (nothing outside a
    call)."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n
