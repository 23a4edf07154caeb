"""Spans of the port's own layers, on the clock the profiler stamps.

``span(name)`` marks a stage of the program (``step.forward``, ``spmm``,
``ell.residual``, ...). Spans are kept while tracing is enabled
(``enable()``), while a ``torch.profiler`` session records, and inside a
span kept on another thread (autograd runs the backward of a card's graph
on a thread of its own); otherwise ``span()`` returns one shared no-op
context. A kept span has:

  * its name and path (``step/step.backward/spmm/ell.residual``);
  * its parent: the span open on its own thread, or, where that thread
    has none open, the latest-started span still open on any thread;
  * its host interval on ``time.time_ns()``, the wall clock on which the
    profiler stamps its events;
  * on a card, its interval on the card's stream, from a pair of CUDA
    events, read by ``collect()``. They are recorded on the stream that
    was current when the thread's outermost open span began (the port
    runs on one stream a device).

A span opened inside one of the same name on its own thread is not kept
again. Under a profiler session a span also opens
``torch.profiler.record_function(name)``, so a Chrome trace carries the
same names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch

_profiling = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Span:
    id: int
    name: str
    path: str
    parent: Optional[int]
    tid: int                     # native thread id
    start_ns: int                # wall clock
    end_ns: int
    # the card's stream, seconds from a reference event of the same
    # collect(); None where no card was in use
    device_start_s: Optional[float] = None
    device_end_s: Optional[float] = None

    @property
    def device_s(self) -> Optional[float]:
        if self.device_start_s is None:
            return None
        return self.device_end_s - self.device_start_s


class Recorder:
    """The spans of one process: those open on each thread, and those
    closed since the last ``collect()``."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.open: list[_Open] = []     # every thread's, in start order
        self.kept: list[tuple] = []
        self.local = threading.local()
        self.ids = itertools.count()
        self.bases: dict[int, torch.cuda.Event] = {}

    def thread(self) -> threading.local:
        """This thread's open spans (``stack``), native id (``tid``) and
        the stream its spans record on (``stream``), each read once: on
        some hosts a thread-id syscall or a current-stream lookup costs
        microseconds."""
        loc = self.local
        if not hasattr(loc, "stack"):
            loc.stack, loc.stream = [], None
            loc.tid = threading.get_native_id()
        return loc

    @staticmethod
    def mark(stream) -> torch.cuda.Event:
        """A timing event recorded now on ``stream``."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def event(self, stream) -> tuple:
        """(the device's reference event, a new event recorded now on
        ``stream``)."""
        base = self.bases.get(stream.device_index)
        if base is None:
            base = self.bases[stream.device_index] = self.mark(stream)
        return base, self.mark(stream)

    def collect(self) -> list[Span]:
        with self.lock:
            kept, self.kept = self.kept, []
            if not self.open:           # a new reference from here on
                self.bases = {}
        out = []
        for (sid, name, path, parent, tid, t0, t1, base, ev0, ev1) in kept:
            d0 = d1 = None
            if base is not None:
                ev1.synchronize()
                d0 = base.elapsed_time(ev0) * 1e-3
                d1 = d0 + ev0.elapsed_time(ev1) * 1e-3
            out.append(Span(sid, name, path, parent, tid, t0, t1, d0, d1))
        return out


class _Open:
    """One span while it is open (the context ``span()`` returns)."""

    __slots__ = ("rec", "name", "path", "id", "parent", "tid", "start_ns",
                 "stream", "base", "ev0", "rf", "skip")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        loc = rec.thread()
        stack = loc.stack
        with rec.lock:
            parent = stack[-1] if stack else (rec.open[-1] if rec.open
                                              else None)
            self.skip = bool(stack) and parent.name == self.name
            if self.skip:
                return self
            self.id = next(rec.ids)
            rec.open.append(self)
        self.parent = None if parent is None else parent.id
        self.path = (self.name if parent is None
                     else f"{parent.path}/{self.name}")
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.base = self.ev0 = None
        if torch.cuda.is_initialized():
            if not stack or loc.stream is None:
                loc.stream = torch.cuda.current_stream()
            self.stream = loc.stream
            self.base, self.ev0 = rec.event(self.stream)
        stack.append(self)
        self.tid = loc.tid
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.skip:
            return False
        end_ns = time.time_ns()
        rec = self.rec
        ev1 = None if self.ev0 is None else rec.mark(self.stream)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec.thread().stack.pop()
        with rec.lock:
            rec.open.remove(self)
            rec.kept.append((self.id, self.name, self.path, self.parent,
                             self.tid, self.start_ns, end_ns, self.base,
                             self.ev0, ev1))
        return False


_REC = Recorder()


def enable() -> None:
    """Keep every span from now on."""
    _REC.on = True


def disable() -> None:
    """Keep spans again only under a profiler session (spans open now
    still close and are kept)."""
    _REC.on = False


def enabled() -> bool:
    """True where ``span()`` keeps what it opens now, on this thread."""
    return _REC.on or bool(_REC.open) or _profiling()


def span(name: str):
    """A context that keeps a span named ``name``, or the shared no-op
    one where nothing is kept."""
    if not (_REC.on or _REC.open or _profiling()):
        return _NOOP
    return _Open(_REC, name)


def collect() -> list[Span]:
    """The spans closed since the last call, in the order they closed,
    and forgets them; on a card it waits for the card to read their
    events."""
    return _REC.collect()
