"""The benchmark's own spans and its reading of the profiler's trace.

``Spans`` records a host-clock span around each call the benchmark makes
into a layer of the program (``prepare``, ``step``, ``loss_read``,
``request``, ...). In a traced run each span is also kept on the wall
clock (``time.time_ns``), the clock on which the profiler stamps the
card's operations, so the two line up without a range of the profiler's
own: the traced window records the card's activity alone (CUPTI), which
adds far less host time a launch than recording the host's operators.

``Trace`` reads the profiler after the window: the device intervals
(kernels, copies, fills), their union inside the ``window`` span, the
device operations that took most time, and the idle gaps attributed to
the benchmark span open when each gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict


class Spans:
    """Host-clock spans, kept in memory as ``(name, start_s, end_s)``
    (``perf_counter``) and, when ``traced``, as ``(name, start_ns,
    end_ns)`` on the wall clock in ``wall``."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.items: list[tuple[str, float, float]] = []
        self.wall: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        w0 = time.time_ns() if self.traced else 0
        t0 = time.perf_counter()
        yield
        self.items.append((name, t0, time.perf_counter()))
        if self.traced:
            self.wall.append((name, w0, time.time_ns()))

    def total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.items if n == name)


def _merge(intervals):
    """Union of ``(start, end)`` intervals, sorted and merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """What the benchmark reads from one profiler session and the run's
    spans (times in seconds from the window's start, on the wall clock)."""

    def __init__(self, prof, spans: Spans):
        windows = [s for s in spans.wall if s[0] == "window"]
        if len(windows) != 1:
            raise RuntimeError(f"{len(windows)} window spans, not 1")
        _, base, end = windows[0]
        self.w0, self.w1 = 0.0, (end - base) * 1e-9
        self.spans = [(n, (a - base) * 1e-9, (b - base) * 1e-9)
                      for n, a, b in spans.wall if n != "window"]
        device = [(name, (start - base) * 1e-9, (start + dur - base) * 1e-9)
                  for name, on_device, annotation, start, dur in _events(prof)
                  if on_device and not annotation]
        self.device = [d for d in device if d[2] > self.w0 and d[1] < self.w1]
        if device and not self.device:
            raise RuntimeError("no device operation of the trace lies in "
                               "the window: the clocks do not line up")
        self.busy = _merge((max(a, self.w0), min(b, self.w1))
                           for _, a, b in self.device)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def device_time(self, contains: str) -> tuple[float, int]:
        """Seconds and count of the device operations whose name holds
        ``contains``."""
        hits = [b - a for n, a, b in self.device if contains in n]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> list:
        per = defaultdict(float)
        for n, a, b in self.device:
            per[n[:80]] += b - a
        return sorted(([n, s] for n, s in per.items()),
                      key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time inside the window summed by the benchmark span open
        where each gap began (``loop`` when none is)."""
        edges = [self.w0] + [x for ab in self.busy for x in ab] + [self.w1]
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        per = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            # the benchmark's spans inside the window follow one another
            # and do not nest, so only the latest-started can hold a
            i = bisect.bisect_right(starts, a) - 1
            inside = i >= 0 and a < spans[i][2]
            per[spans[i][0] if inside else "loop"] += b - a
        return sorted(([n, s] for n, s in per.items()),
                      key=lambda kv: -kv[1])[:k]


def _events(prof):
    """``(name, on_device, is_annotation, start_ns, duration_ns)`` of every
    event the profiler kept (its kineto events, stamped on the wall
    clock)."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None or not hasattr(results, "events"):
        raise RuntimeError("this torch's profiler exposes no kineto events")
    for e in results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        yield (e.name(), "CUDA" in str(e.device_type()),
               bool(e.is_user_annotation()) or "annotation" in kind,
               int(e.start_ns()), int(e.duration_ns()))
