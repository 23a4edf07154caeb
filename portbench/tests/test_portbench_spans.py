"""The program's spans read by the benchmark, on hand-made timelines: each
device operation put down to the program span open at its launch (a
kernel launched from autograd's thread inside ``step.backward`` goes to
``ell.residual``), idle gaps named by span path, and the new readers'
values from the spans' CUDA-event times."""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import pytest

from portbench import harness, program_spans, span_attribution

T0 = 1_790_000_000_000_000_000          # a wall-clock start, in ns
US = 1000


@dataclasses.dataclass(frozen=True)
class Span:
    """The fields of ``ggad_tpu_torch.utils.tracing.Span`` the readers
    use; times in µs from ``T0``, device times in ms."""

    id: int
    name: str
    path: str
    parent: Optional[int]
    start_us: int
    end_us: int
    dev_start_ms: Optional[float] = None
    dev_end_ms: Optional[float] = None

    @property
    def start_ns(self):
        return T0 + self.start_us * US

    @property
    def end_ns(self):
        return T0 + self.end_us * US

    @property
    def device_start_s(self):
        return None if self.dev_start_ms is None else self.dev_start_ms / 1e3

    @property
    def device_end_s(self):
        return None if self.dev_end_ms is None else self.dev_end_ms / 1e3

    @property
    def device_s(self):
        if self.dev_start_ms is None:
            return None
        return (self.dev_end_ms - self.dev_start_ms) / 1e3


def train_spans():
    """One step: the forward's product on the main thread, the backward's
    product and its residual on autograd's thread, under
    ``step.backward``."""
    return [
        Span(0, "step", "step", None, 0, 100, 0.0, 9.0),
        Span(1, "step.forward", "step/step.forward", 0, 5, 30, 0.5, 3.0),
        Span(2, "spmm", "step/step.forward/spmm", 1, 8, 28, 1.0, 3.0),
        Span(3, "step.backward", "step/step.backward", 0, 40, 90, 4.0, 8.0),
        Span(4, "spmm", "step/step.backward/spmm", 3, 45, 80, 4.5, 7.5),
        Span(5, "ell.residual", "step/step.backward/spmm/ell.residual", 4,
             50, 70, 5.0, 7.0),
    ]


def ns(us):
    return T0 + us * US


def test_a_kernel_launched_in_the_backward_thread_goes_to_the_residual():
    # (name, start, end, correlation) and the launches by correlation
    ops = [("k_fwd", ns(12), ns(30), 1),
           ("k_res", ns(60), ns(75), 2),       # launched at 55, on the
           ("k_tail", ns(96), ns(99), 3),      # backward's thread
           ("k_read", ns(104), ns(108), 4),    # in the benchmark's span
           ("k_lost", ns(110), ns(112), 5)]    # no launch kept
    launches = {1: ns(6), 2: ns(55), 3: ns(95), 4: ns(103)}
    bench = [("step", ns(0), ns(100)), ("loss_read", ns(100), ns(109)),
             ("window", ns(0), ns(120))]
    out = span_attribution.breakdown(ops, launches, train_spans(), bench,
                                     (ns(0), ns(120)))
    spans = out["spans"]
    res = spans["step/step.backward/spmm/ell.residual"]
    assert res["count"] == 1 and res["device_s"] == pytest.approx(15e-6)
    assert spans["step/step.forward/spmm"]["device_s"] == 0.0
    assert spans["step/step.forward"]["device_s"] == pytest.approx(18e-6)
    assert spans["step"]["device_s"] == pytest.approx(3e-6)
    assert spans["step"]["device_incl_s"] == pytest.approx(36e-6)
    assert spans["step/step.backward"]["host_s"] == pytest.approx(50e-6)
    assert out["outside"] == {"loss_read": pytest.approx(4e-6),
                              "unlinked": pytest.approx(2e-6)}
    assert out["linked_share"] == pytest.approx(0.8)
    assert out["attributed_share"] == pytest.approx(36 / 42)
    assert out["units"] == 1
    assert out["ell_residual_ms"] == pytest.approx(15e-3)
    assert out["spmm_ms"] == pytest.approx(15e-3)


def test_idle_gaps_are_named_by_span_path():
    ops = [("k_a", ns(10), ns(30), 1), ("k_b", ns(60), ns(75), 2),
           ("k_c", ns(96), ns(99), 3), ("k_d", ns(100), ns(104), 4),
           ("k_e", ns(110), ns(112), 5)]
    launches = {1: ns(6), 2: ns(55), 3: ns(95), 4: ns(99), 5: ns(109)}
    bench = [("step", ns(0), ns(100)), ("loss_read", ns(100), ns(110)),
             ("window", ns(0), ns(120))]
    out = span_attribution.breakdown(ops, launches, train_spans(), bench,
                                     (ns(0), ns(120)))
    gaps = dict(out["idle_gaps"])
    # 0-10, 30-60 and 99-100 begin in the step alone, 75-96 in the
    # backward's product, 104-110 in the loss read, 112-120 in the loop
    assert gaps == {"step": pytest.approx(41e-6),
                    "step/step.backward/spmm": pytest.approx(21e-6),
                    "loss_read": pytest.approx(6e-6),
                    "loop": pytest.approx(8e-6)}
    assert out["busy_s"] == pytest.approx(44e-6)


def test_open_at_gives_the_latest_started_open_interval():
    at = span_attribution.OpenAt([(0, 100, "a"), (10, 20, "b"),
                                  (15, 50, "c")])
    assert [at(t) for t in (5, 12, 18, 20, 49, 50, 99, 100)] == [
        "a", "b", "c", "c", "c", "a", "a", None]


def score_spans():
    """Two requests: forward, then the copy that ends on the host."""
    out = []
    for r, (t, d) in enumerate(((0, 0.0), (200, 80.0))):
        base = 10 * r
        out += [Span(base, "score", "score", None, t, t + 150, d, d + 76.0),
                Span(base + 1, "score.forward", "score/score.forward", base,
                     t + 1, t + 40, d + 0.1, d + 75.0),
                Span(base + 2, "spmm", "score/score.forward/spmm", base + 1,
                     t + 2, t + 30, d + 0.2, d + 72.0),
                Span(base + 3, "ell.residual",
                     "score/score.forward/spmm/ell.residual", base + 2,
                     t + 5, t + 25, d + 3.0, d + 70.0),
                Span(base + 4, "score.copy", "score/score.copy", base,
                     t + 40, t + 150, d + 75.0, d + 75.4 + 0.2 * r)]
    return out


def context(spans, monkeypatch, wall=((0, 1000),)):
    from ggad_tpu_torch.utils import tracing

    kept = list(spans)
    monkeypatch.setattr(tracing, "collect", lambda: kept)
    bench = harness.Context(seed=1, cell=None, spans=None, setup_s=0.0,
                            window=None, trace=object())
    bench.spans = type("S", (), {"wall": [("window", ns(a), ns(b))
                                          for a, b in wall]})()
    return bench


@pytest.mark.parametrize("metric,spans,want", [
    ("spmm_ms.train", train_spans, 2.0 + 3.0),
    ("ell_residual_ms.train", train_spans, 2.0),
    ("spmm_ms.score", score_spans, 71.8),
    ("ell_residual_ms.score", score_spans, 67.0),
    ("copy_ms.score", score_spans, 0.5),
])
def test_each_reader_gives_its_value(monkeypatch, metric, spans, want):
    ctx = context(spans(), monkeypatch)
    assert harness.reader(metric).read(ctx) == pytest.approx(want)


def test_readers_find_nothing_without_the_programs_spans(monkeypatch):
    ctx = context(train_spans(), monkeypatch, wall=((500, 600),))
    assert harness.reader("spmm_ms.train").read(ctx) is None  # none inside
    # no device times (a host run): nothing to read
    host = [dataclasses.replace(s, dev_start_ms=None, dev_end_ms=None)
            for s in train_spans()]
    assert harness.reader("spmm_ms.train").read(
        context(host, monkeypatch)) is None
    # a program without utils.tracing (as before the spans)
    import ggad_tpu_torch.utils

    monkeypatch.delattr(ggad_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "ggad_tpu_torch.utils.tracing", None)
    bench = harness.Context(seed=1, cell=None, spans=None, setup_s=0.0,
                            window=None, trace=object())
    for metric in ("spmm_ms.train", "ell_residual_ms.score",
                   "copy_ms.score"):
        assert harness.reader(metric).read(bench) is None
    assert program_spans.window_spans(
        dataclasses.replace(bench, trace=None)) is None

