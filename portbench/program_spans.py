"""The program's own spans in a traced run, for the metric readers.

The port keeps a span around each of its stages (``ggad_tpu_torch.utils.
tracing``) while a ``torch.profiler`` session records, so the traced
window's steps and requests come with their stages, sparse products and
ELL parts. On a card each span carries its interval on the card's stream
(a pair of CUDA events), so its device time is read without linking the
profiler's kernels to their launches.

``window_spans(ctx)`` gives the spans that started inside the benchmark's
``window`` span, read once a run and shared by the readers; None where
the program keeps no spans (a program without ``utils.tracing``) or the
run was not traced.
"""

from __future__ import annotations

import statistics

_last: tuple = (None, None)      # (the run's context, its spans)


def window_spans(ctx):
    global _last
    if ctx.trace is None:
        return None
    if _last[0] is ctx:
        return _last[1]
    try:
        from ggad_tpu_torch.utils import tracing
    except ImportError:
        return None
    windows = [(a, b) for n, a, b in ctx.spans.wall if n == "window"]
    kept = tracing.collect()
    spans = None
    if len(windows) == 1 and kept:
        w0, w1 = windows[0]
        spans = [s for s in kept if w0 <= s.start_ns <= w1]
    _last = (ctx, spans)
    return spans


def units(spans) -> list:
    """The window's steps and requests: the outermost ``step`` and
    ``score`` spans."""
    return [s for s in spans if s.parent is None
            and s.name in ("step", "score")]


def outermost(spans, name: str) -> list:
    """The spans named ``name`` inside none of the same name."""
    return [s for s in spans if s.name == name
            and s.path.split("/").count(name) == 1]


def per_unit_ms(spans, name: str):
    """Device time a step or request of the outermost ``name`` spans (ms),
    or None where there are none or they carry no device times."""
    if not spans:
        return None
    hits = outermost(spans, name)
    n = len(units(spans))
    if not hits or n == 0 or any(s.device_s is None for s in hits):
        return None
    return 1e3 * sum(s.device_s for s in hits) / n


def copy_ms(spans):
    """The median over the requests of the time from the end of a
    request's ``score.forward`` on the card's stream to the end of its
    ``score.copy`` span (ms)."""
    if not spans:
        return None
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent, {})[s.name] = s
    gaps = []
    for req in units(spans):
        kids = by_parent.get(req.id, {})
        fwd, cp = kids.get("score.forward"), kids.get("score.copy")
        if fwd is None or cp is None or cp.device_end_s is None:
            continue
        gaps.append(cp.device_end_s - fwd.device_end_s)
    return 1e3 * statistics.median(gaps) if gaps else None
