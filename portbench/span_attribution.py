"""The card's operations put down to the program's spans by their launches.

A profiler session that records the card (CUDA activity alone) keeps,
beside each kernel, copy and fill, the runtime call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) under the same
correlation id, with the call's start on the host's wall clock. Each
operation is put down to the latest-started program span
(``ggad_tpu_torch.utils.tracing``) still open at its launch, over every
thread (autograd runs a card's backward on a thread of its own); where no
program span is open, to the benchmark's span open then, else to
``loop``. Each idle gap of the card goes to the span open where it
began, named by its path. ``breakdown`` sums all of it; ``span_report.py``
prints it.
"""

from __future__ import annotations

import heapq
import statistics
from collections import defaultdict


def kineto(prof) -> tuple:
    """(device operations ``(name, start_ns, end_ns, correlation)``,
    ``{correlation: launch start_ns}`` of the runtime and driver calls) of
    a profiler session."""
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        if e.is_user_annotation() or "annotation" in kind:
            continue
        if "CUDA" in str(e.device_type()):
            start = int(e.start_ns())
            ops.append((e.name(), start, start + int(e.duration_ns()),
                        int(e.correlation_id())))
        elif ("runtime" in kind or "driver" in kind
              or (not kind and e.name().startswith("cu"))):
            launches[int(e.correlation_id())] = int(e.start_ns())
    return ops, launches


class OpenAt:
    """The item of the latest-started interval ``(start, end, item)`` open
    at each of a non-decreasing sequence of times (None where none is)."""

    def __init__(self, intervals):
        self.items = sorted(intervals, key=lambda x: x[0])
        self.next = 0
        self.heap: list = []

    def __call__(self, t):
        while (self.next < len(self.items)
               and self.items[self.next][0] <= t):
            start, end, item = self.items[self.next]
            heapq.heappush(self.heap, (-start, self.next, end, item))
            self.next += 1
        while self.heap and self.heap[0][2] <= t:
            heapq.heappop(self.heap)
        return self.heap[0][3] if self.heap else None


def _merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _prefixes(path: str):
    parts = path.split("/")
    return ["/".join(parts[:i + 1]) for i in range(len(parts))]


def breakdown(ops, launches, program, bench, window, setup=(),
              top: int = 12) -> dict:
    """What the traced window's card time and idle time went to.

    ``ops`` and ``launches`` as ``kineto`` gives them; ``program``: the
    program's spans kept in the run (``id``, ``name``, ``path``,
    ``parent``, ``start_ns``, ``end_ns``); ``bench``: the benchmark's
    spans ``(name, start_ns, end_ns)``; ``window``: ``(start_ns,
    end_ns)``; ``setup``: program spans kept before the window."""
    w0, w1 = window
    inside = [s for s in program if w0 <= s.start_ns <= w1]
    by_id = {s.id: s for s in inside}
    ops = [o for o in ops if o[2] > w0 and o[1] < w1]
    linked = sorted((launches[o[3]], i) for i, o in enumerate(ops)
                    if o[3] in launches)

    prog_at = OpenAt((s.start_ns, s.end_ns, s) for s in inside)
    bench_at = OpenAt((a, b, n) for n, a, b in bench if n != "window")
    owner: list = ["unlinked"] * len(ops)   # a span, or a name
    for t, i in linked:
        s = prog_at(t)
        owner[i] = s if s is not None else (bench_at(t) or "loop")

    def clip(o):
        return (min(o[2], w1) - max(o[1], w0)) * 1e-9

    excl, incl = defaultdict(float), defaultdict(float)
    outside = defaultdict(float)     # benchmark spans, loop, unlinked
    for o, who in zip(ops, owner):
        if isinstance(who, str):
            outside[who] += clip(o)
            continue
        excl[who.path] += clip(o)
        for p in _prefixes(who.path):
            incl[p] += clip(o)

    busy = _merge((max(o[1], w0), min(o[2], w1)) for o in ops)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    device_s = sum(clip(o) for o in ops)
    attributed_s = sum(excl.values())

    # idle gaps by the span open where each began
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    prog_at = OpenAt((s.start_ns, s.end_ns, s.path) for s in inside)
    bench_at = OpenAt((a, b, n) for n, a, b in bench if n != "window")
    idle = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            idle[prog_at(a) or bench_at(a) or "loop"] += (b - a) * 1e-9

    spans = {}
    for s in inside:
        row = spans.setdefault(s.path, {"count": 0, "host_s": 0.0})
        row["count"] += 1
        row["host_s"] += (s.end_ns - s.start_ns) * 1e-9
    for path, row in spans.items():
        row["device_s"] = excl.get(path, 0.0)
        row["device_incl_s"] = incl.get(path, 0.0)
    setup_host = defaultdict(float)
    for s in setup:
        setup_host[s.path] += (s.end_ns - s.start_ns) * 1e-9

    units = [s for s in inside if s.parent is None
             and s.name in ("step", "score")]
    n = max(len(units), 1)

    def per_unit_ms(name):
        t = sum(v for p, v in excl.items() if name in p.split("/"))
        return 1e3 * t / n

    # a request's copy: from its forward's last operation to the copy's end
    last_end = defaultdict(int)
    for o, s in zip(ops, owner):
        while s is not None and not isinstance(s, str):
            if s.name == "score.forward":
                last_end[s.id] = max(last_end[s.id], o[2])
                break
            s = by_id.get(s.parent)
    kids = defaultdict(dict)
    for s in inside:
        kids[s.parent][s.name] = s
    copies = []
    for u in units:
        fwd, cp = kids[u.id].get("score.forward"), kids[u.id].get("score.copy")
        if fwd is not None and cp is not None and fwd.id in last_end:
            copies.append((cp.end_ns - last_end[fwd.id]) * 1e-6)

    return {
        "ops": len(ops),
        "linked_share": len(linked) / len(ops) if ops else None,
        "busy_s": busy_s,
        "device_s": device_s,
        "attributed_share": attributed_s / device_s if device_s else None,
        "attributed_over_busy": attributed_s / busy_s if busy_s else None,
        "outside": dict(outside),
        "units": len(units),
        "spmm_ms": per_unit_ms("spmm"),
        "ell_residual_ms": per_unit_ms("ell.residual"),
        "copy_ms": statistics.median(copies) if copies else None,
        "idle_gaps": sorted(([p, s] for p, s in idle.items()),
                            key=lambda kv: -kv[1])[:top],
        "spans": dict(sorted(spans.items())),
        "setup_host_s": dict(sorted(setup_host.items())),
    }
