"""The port's span recorder (``utils.tracing``) and the spans and counters
its layers keep: off by default and then a shared no-op, nesting and
paths on the wall clock, a span on another thread under the one open, a
train step's stages and ELL parts on a tiny graph whose rows pass the
sigma cap, and no number changed by tracing."""

import threading

import numpy as np
import pytest
import torch

from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.ops import ell_spmm as ell_mod
from ggad_tpu_torch.ops.ell_spmm import ell_spmm
from ggad_tpu_torch.train.full_batch import FullBatchTrainer
from ggad_tpu_torch.utils import tracing

N_H = 16
STAGES = ("step.noise", "step.forward", "step.loss", "step.backward",
          "step.optimizer")
COUNTERS = ("bucket_slots", "residual_entries", "residual_chunks")


@pytest.fixture(scope="module", autouse=True)
def optimizer_imported():
    """A first torch optimizer imports ``torch._dynamo`` (seconds, once a
    process): paid here rather than inside the first step a test times."""
    torch.optim.Adam([torch.zeros(1, requires_grad=True)])


@pytest.fixture
def traced():
    """Tracing on for the test, nothing kept before or after it."""
    tracing.collect()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.collect()


def dense_graph():
    """150 nodes of 64–87 entries a row: most rows pass the sigma cap of
    64, so each ELL pass has a residual."""
    return synthetic_gad(n_nodes=150, avg_degree=90, feat_dim=8,
                         n_communities=2, anomaly_rate=0.1, seed=3)


def ell_trainer(ds):
    tr = FullBatchTrainer(ds, embedding_dim=N_H, spmm_impl="ell",
                          noise_mean=0.0, noise_std=1.0, device="cpu")
    tr.model.load_state_dict(tr.init(torch.Generator().manual_seed(5)))
    tr.prepare_training()
    return tr


def test_off_keeps_nothing_and_returns_the_shared_noop():
    tracing.collect()
    assert not tracing.enabled()
    first = tracing.span("step")
    assert first is tracing.span("spmm") is tracing._NOOP
    with tracing.span("step"):
        with tracing.span("spmm"):
            pass
    assert tracing.collect() == []


def test_nesting_paths_and_wall_clock_order(traced):
    with tracing.span("step"):
        with tracing.span("step.forward"):
            with tracing.span("spmm"):
                with tracing.span("spmm"):      # the same name: not again
                    pass
        with tracing.span("step.loss"):
            pass
    spans = {s.path: s for s in tracing.collect()}
    assert sorted(spans) == ["step", "step/step.forward",
                             "step/step.forward/spmm", "step/step.loss"]
    step, fwd = spans["step"], spans["step/step.forward"]
    mm, loss = spans["step/step.forward/spmm"], spans["step/step.loss"]
    assert step.parent is None
    assert (fwd.parent, mm.parent, loss.parent) == (step.id, fwd.id,
                                                     step.id)
    assert (step.start_ns <= fwd.start_ns <= mm.start_ns <= mm.end_ns
            <= fwd.end_ns <= loss.start_ns <= loss.end_ns <= step.end_ns)
    assert all(s.device_s is None for s in spans.values())   # no card


def test_a_span_on_another_thread_takes_the_open_span_as_parent(traced):
    done = []

    def worker():
        with tracing.span("spmm"):
            with tracing.span("ell.residual"):
                done.append(threading.get_native_id())

    with tracing.span("step"):
        with tracing.span("step.backward"):
            # tracing off now: spans opened inside a kept one still are
            tracing.disable()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and len(done) == 1
    spans = {s.path: s for s in tracing.collect()}
    assert set(spans) == {"step", "step/step.backward",
                          "step/step.backward/spmm",
                          "step/step.backward/spmm/ell.residual"}
    back, mm = spans["step/step.backward"], spans["step/step.backward/spmm"]
    assert mm.parent == back.id and mm.tid == done[0] != back.tid
    assert back.start_ns <= mm.start_ns <= mm.end_ns <= back.end_ns


def expected_counts(tr, chunk_elems: int) -> dict:
    """The three counters of one step, from the tables the step passes
    over: gcn2's and the seed rows' products forward and backward, the
    margin's subset colsum forward, and its two products backward."""
    sub = tr.aff_sub
    tables = [tr.adj.tables.fwd, tr.seed_adj.tables.fwd, sub.bwd, sub.fwd,
              sub.bwd, tr.seed_adj.tables.bwd, tr.adj.tables.bwd]
    chunks = 0
    for t in tables:
        e = t.n_overflow                 # a table without one skips it
        chunk = e if e * N_H <= chunk_elems else max(chunk_elems // N_H, 1)
        chunks += -(-e // chunk) if e else 0
    return {"bucket_slots": sum(t.n_slots for t in tables),
            "residual_entries": sum(t.n_overflow for t in tables),
            "residual_chunks": chunks}


def test_ell_train_step_keeps_its_stages_and_counts(traced, monkeypatch):
    chunk_elems = 64 * N_H               # 64 residual entries a chunk
    monkeypatch.setattr(ell_mod, "_OV_CHUNK_ELEMS", chunk_elems)
    tr = ell_trainer(dense_graph())
    assert tr.route == "ell" and tr.adj.tables.fwd.n_overflow > 0
    tracing.collect()                    # the set-up's spans
    before = {k: getattr(ell_spmm, k) for k in COUNTERS}
    tr.train_step(torch.Generator().manual_seed(1))
    got = {k: getattr(ell_spmm, k) - before[k] for k in COUNTERS}
    paths = {s.path for s in tracing.collect()}

    assert {"step", *(f"step/{s}" for s in STAGES)} <= paths
    for where in ("step/step.forward/spmm", "step/step.backward/spmm",
                  "step/step.loss/affinity", "step/step.backward/affinity",
                  "step/step.forward/spmm/ell.buckets",
                  "step/step.forward/spmm/ell.residual",
                  "step/step.backward/affinity/ell.residual"):
        assert where in paths, where
    want = expected_counts(tr, chunk_elems)
    assert got == want
    assert want["residual_chunks"] > 7   # several chunks a residual pass


def test_set_up_spans_and_scoring_spans():
    tracing.collect()
    tracing.enable()
    try:
        tr = ell_trainer(dense_graph())
        tr.eval_scores()
    finally:
        tracing.disable()
    paths = {s.path for s in tracing.collect()}
    assert {"prepare", "prepare/prepare.normalize", "prepare/prepare.route",
            "prepare/prepare.tables", "prepare/prepare.ax",
            "prepare/prepare.ax/spmm", "prepare_training",
            "prepare_training/prepare.transpose",
            "prepare_training/prepare.seed_rows",
            "prepare_training/prepare.subset", "score",
            "score/score.forward", "score/score.forward/spmm",
            "score/score.forward/spmm/ell.residual",
            "score/score.copy"} <= paths


def test_tracing_changes_no_number():
    ds = dense_graph()
    runs = []
    for on in (False, True):
        tracing.collect()
        if on:
            tracing.enable()
        try:
            tr = ell_trainer(ds)
            gen = torch.Generator().manual_seed(7)
            losses = [tr.train_step(gen) for _ in range(2)]
            runs.append((torch.stack([torch.stack(list(x)) for x in losses]),
                         tr.params(), tr.eval_scores()))
        finally:
            tracing.disable()
        assert bool(tracing.collect()) == on
    (l0, p0, s0), (l1, p1, s1) = runs
    assert torch.equal(l0, l1)
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    np.testing.assert_array_equal(s0, s1)
