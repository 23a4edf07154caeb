"""The trace reading on a hand-made timeline: the window, the union of
the device's intervals, the idle gaps by the benchmark's span."""

from __future__ import annotations

import pytest

from portbench.tracing import Spans, Trace

T0 = 1_790_000_000_000_000_000          # a wall-clock start, in ns


class Event:
    def __init__(self, name, device, start_us, end_us, annotation=False):
        self._n, self._d, self._a = name, device, annotation
        self._s, self._e = T0 + start_us * 1000, T0 + end_us * 1000

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def activity_type(self):
        return "user_annotation" if self._a else "kernel"

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


class Prof:
    def __init__(self, events):
        class Results:
            def events(self_inner):
                return events

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


def timeline():
    spans = Spans(traced=True)
    spans.wall = [("step", T0, T0 + 30_000),
                  ("loss_read", T0 + 30_000, T0 + 100_000),
                  ("window", T0, T0 + 100_000)]
    prof = Prof([
        Event("step", True, 0, 30, annotation=True),     # the card's copy
        Event("k_a", True, 10, 40),
        Event("k_b", True, 35, 50),                      # overlaps k_a
        Event("k_a", True, 60, 90),
        Event("aten::mm", False, 5, 6),                  # a host op
        Event("k_late", True, 120, 130),                 # after the window
    ])
    return prof, spans


def test_busy_union_and_idle_share():
    t = Trace(*timeline())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(70e-6)          # 10-50 and 60-90
    secs, count = t.device_time("k_a")
    assert count == 2 and secs == pytest.approx(60e-6)


def test_top_ops_and_gaps_by_span():
    t = Trace(*timeline())
    assert [n for n, _ in t.top_ops()] == ["k_a", "k_b"]
    gaps = dict(t.idle_gaps())
    # 0-10 inside a step; 50-60 and 90-100 inside the loss read
    assert gaps["step"] == pytest.approx(10e-6)
    assert gaps["loss_read"] == pytest.approx(20e-6)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        Trace(Prof([Event("k_a", True, 0, 1)]), Spans(traced=True))


def test_clocks_that_do_not_line_up_are_refused():
    prof, spans = timeline()
    spans.wall[-1] = ("window", T0 + 10**12, T0 + 10**12 + 100_000)
    with pytest.raises(RuntimeError):
        Trace(prof, spans)
