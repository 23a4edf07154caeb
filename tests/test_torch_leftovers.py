"""The last helpers of the port against ``ggad_tpu``: ``viz`` (the four
figures, the ROC and PR curves' arrays), ``Graph.transpose_host``,
``parallel.halo_trainer.halo_training_run``
against ``FullBatchTrainer(mesh=D)``, and ``FullBatchTrainer``'s
``profile_dir`` window (driven with CPU activity here; on a card it traces
the host and the card)."""

import json
import os

import matplotlib.figure
import numpy as np
import pytest
import torch

from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import from_coo
from ggad_tpu_torch.parallel.halo_trainer import halo_training_run
from ggad_tpu_torch.train import full_batch
from ggad_tpu_torch.train.full_batch import FullBatchTrainer

N_H = 16
DS_KW = dict(n_nodes=240, avg_degree=8, feat_dim=12, n_communities=3,
             anomaly_rate=0.1, seed=3)


def viz_inputs():
    """``tests/test_utils_config.py::test_viz_outputs``'s inputs."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 100)
    scores = rng.normal(size=100)
    pops = (rng.normal(0.8, 0.1, 50), rng.normal(0.2, 0.1, 20),
            rng.normal(0.3, 0.2, 30))
    methods = {"GGAD": pops,
               "TAM": (rng.normal(0.7, 0.1, 50), rng.normal(0.4, 0.1, 20),
                       rng.normal(0.35, 0.2, 30))}
    return labels, scores, pops, methods


def draw_all(viz, out, labels, scores, pops, methods):
    return [viz.draw_affinity_pdf(*pops, str(out / "fig/aff.pdf")),
            viz.draw_roc(labels, scores, str(out / "fig/roc.png")),
            viz.draw_pr(labels, scores, str(out / "fig/pr.png")),
            viz.draw_affinity_pdf_methods(methods,
                                          str(out / "fig/aff_methods.svg"))]


@pytest.fixture
def plotted(monkeypatch):
    """Each saved figure's plotted lines, as (x, y) arrays."""
    saved = []
    orig = matplotlib.figure.Figure.savefig

    def savefig(fig, *a, **kw):
        saved.append([line.get_xydata().copy() for ax in fig.axes
                      for line in ax.lines])
        return orig(fig, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return saved


def test_viz_writes_the_figures_with_jax_curves(tmp_path, plotted):
    from ggad_tpu import viz as jviz
    from ggad_tpu_torch import viz

    labels, scores, pops, methods = viz_inputs()
    paths = draw_all(viz, tmp_path / "port", labels, scores, pops, methods)
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0
    ours = list(plotted)
    plotted.clear()
    draw_all(jviz, tmp_path / "jax", labels, scores, pops, methods)
    assert len(ours) == len(plotted) == 4
    for a, b in zip(ours, plotted):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # the curves as arrays: ROC from (0, 0) to (1, 1), PR's recall to 1
    fpr, tpr = viz.roc_curve(labels, scores)
    np.testing.assert_array_equal(np.stack([fpr, tpr], 1), ours[1][0])
    recall, precision = viz.pr_curve(labels, scores)
    np.testing.assert_array_equal(np.stack([recall, precision], 1),
                                  ours[2][0])
    assert (fpr[0], tpr[0], fpr[-1], tpr[-1]) == (0, 0, 1, 1)
    assert recall[-1] == 1


def test_viz_takes_tensors(tmp_path, plotted):
    from ggad_tpu_torch import viz

    labels, scores, pops, methods = viz_inputs()
    draw_all(viz, tmp_path / "np", labels, scores, pops, methods)
    as_np = list(plotted)
    plotted.clear()
    t = torch.as_tensor
    draw_all(viz, tmp_path / "t", t(labels),
             torch.tensor(scores, requires_grad=True), [t(p) for p in pops],
             {k: [t(p) for p in v] for k, v in methods.items()})
    for a, b in zip(as_np, plotted):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_transpose_host_equals_jax():
    from ggad_tpu.graph import from_coo as j_from_coo

    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 90, 700), rng.integers(0, 90, 700)
    v = rng.random(700).astype(np.float32)
    g = from_coo(r, c, v, 90, pad_multiple=64, device="cpu")
    t = g.transpose_host()
    j = j_from_coo(r, c, v, 90, pad_multiple=64).transpose_host()
    assert (t.n_nodes, t.n_edges, t.e_pad) == (j.n_nodes, j.n_edges,
                                               j.e_pad) == (90, 700, g.e_pad)
    for name in ("row", "col", "val", "indptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    back = t.transpose_host()
    for name in ("row", "col", "val", "indptr"):
        assert torch.equal(getattr(back, name), getattr(g, name))


def rel_close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(got - ref) <= tol * (1 + np.abs(ref))), (got, ref)


@pytest.mark.parametrize("D", [2, 4])
def test_halo_training_run_equals_the_sharded_trainer(D):
    """``halo_training_run`` is ``FullBatchTrainer(mesh=D)``'s seeded init
    and train steps: the same generator gives the same losses and
    weights; the default generator is the one seeded with ``seed``."""
    ds = synthetic_gad(**DS_KW)
    kw = dict(noise_mean=0.02, noise_std=0.01, seed=2)
    tr = FullBatchTrainer(ds, embedding_dim=N_H, mesh=D, device="cpu", **kw)
    tr.model.load_state_dict(tr.initial_state())
    gen = torch.Generator().manual_seed(11)
    ref = [tr.train_step(gen) for _ in range(3)][-1]
    params, losses = halo_training_run(
        D, ds, n_h=N_H, n_steps=3, device="cpu",
        generator=torch.Generator().manual_seed(11), **kw)
    rel_close([float(x) for x in losses], [float(x) for x in ref], 1e-5)
    assert params.keys() == tr.params().keys()
    for k, v in tr.params().items():
        rel_close(params[k], v, 1e-5)
    # the default noise generator: seeded with ``seed``
    _, seeded = halo_training_run(D, ds, n_h=N_H, n_steps=2, device="cpu",
                                  **kw)
    _, explicit = halo_training_run(
        D, ds, n_h=N_H, n_steps=2, device="cpu",
        generator=torch.Generator().manual_seed(kw["seed"]), **kw)
    assert [float(x) for x in seeded] == [float(x) for x in explicit]


def trace_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(int(e["name"].split()[1]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("train_step "))


def stages_by_step(path):
    """The names of the spans inside each ``train_step <epoch>`` range."""
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    return {int(s["name"].split()[1]):
            {e["name"] for e in spans
             if s["ts"] <= e["ts"] <= s["ts"] + s["dur"]}
            for s in spans if s["name"].startswith("train_step ")}


def test_profile_window_traces_steps_2_to_4(tmp_path, monkeypatch):
    """``train()`` with ``profile_dir`` traces epochs 2..4 (JAX's window)
    as a Chrome trace; here with CPU activity, in place of the card's."""
    from torch.profiler import ProfilerActivity

    ds = synthetic_gad(**DS_KW)
    kw = dict(embedding_dim=N_H, num_epoch=6, eval_every=3, device="cpu")
    # a CPU trainer traces nothing, as JAX traces only on the TPU
    FullBatchTrainer(ds, profile_dir=str(tmp_path / "none"), **kw).train()
    assert not (tmp_path / "none").exists()

    monkeypatch.setattr(full_batch, "profile_activities",
                        lambda device: [ProfilerActivity.CPU])
    out = tmp_path / "trace"
    res = FullBatchTrainer(ds, profile_dir=str(out), **kw).train()
    assert len(res.history) >= 3
    files = os.listdir(out)
    assert files == ["trace_steps_2_4.json"]
    assert trace_steps(out / files[0]) == [2, 3, 4]
    # each traced step carries the step's own spans (utils.tracing)
    stages = {"step", "step.noise", "step.forward", "step.loss",
              "step.backward", "step.optimizer", "spmm", "affinity"}
    by_step = stages_by_step(out / files[0])
    assert sorted(by_step) == [2, 3, 4]
    for epoch, names in by_step.items():
        assert stages <= names, (epoch, stages - names)


def test_profile_window_alone_on_cpu_activity(tmp_path):
    """The window helper driven step by step: starts at the first epoch
    ≥ 2, stops after epoch 4's step, and traces nothing after."""
    from torch.profiler import ProfilerActivity

    win = full_batch.ProfileWindow(str(tmp_path), [ProfilerActivity.CPU])
    x = torch.ones(8)
    for epoch in range(7):
        win.before(epoch)
        with win.step(epoch):
            y = (x * epoch).sum()
        win.after(epoch, y)
    assert win.path == str(tmp_path / "trace_steps_2_4.json")
    assert trace_steps(win.path) == [2, 3, 4]
