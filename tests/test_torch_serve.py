"""Serving end to end against ``ggad_tpu``, the CLI, checkpoints, the
package's isolation from JAX and its device rule.

Scores from weights converted out of the JAX init match
``ggad_tpu.FullBatchTrainer(...).eval_scores`` to 1e-5 rel/abs (f32,
sums in another order); AUROC/AP to 1e-6.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.train.full_batch import FullBatchTrainer as JaxTrainer
import ggad_tpu_torch
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.interop import params_from_flax
from ggad_tpu_torch.serve import Scorer, score_dataset
from ggad_tpu_torch.train.checkpoint import Checkpointer
from ggad_tpu_torch.train.full_batch import FullBatchTrainer, maybe_bcsr
from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_H = 24
DS_KW = dict(n_nodes=300, avg_degree=8, feat_dim=16, n_communities=3,
             anomaly_rate=0.1, seed=2)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX init's params and its eval scores on both SpMM routes."""
    ds = jax_synthetic_gad(**DS_KW)
    scores = {}
    params = None
    for impl in ("xla", "pallas"):
        tr = JaxTrainer(ds, num_epoch=0, embedding_dim=N_H, spmm_impl=impl)
        if params is None:
            params, _ = tr.init(jax.random.PRNGKey(3))
            params = jax.tree.map(np.asarray, params)
        tr = JaxTrainer(ds, num_epoch=0, embedding_dim=N_H, spmm_impl=impl,
                        initial_params=params)
        scores[impl] = (tr.eval_scores(params), tr.evaluate(params))
    return params, scores


@pytest.fixture
def ckpt_dir(jax_side, tmp_path):
    params, _ = jax_side
    Checkpointer(str(tmp_path)).save(
        5, {"params": params_from_flax(params), "epoch": 5})
    return str(tmp_path)


@pytest.mark.parametrize("impl,jax_impl,dtype", [
    ("coo", "xla", "float32"), ("bcsr", "pallas", "float32"),
    ("auto", "pallas", "float32")])
def test_score_dataset_matches_jax(jax_side, ckpt_dir, impl, jax_impl, dtype):
    _, scores = jax_side
    j_scores, (j_auc, j_ap) = scores[jax_impl]
    res = score_dataset(ckpt_dir, synthetic_gad(**DS_KW), embedding_dim=N_H,
                        spmm_impl=impl, spmm_dtype=dtype, device="cpu")
    assert res.step == 5
    np.testing.assert_allclose(res.scores, j_scores, rtol=1e-5, atol=1e-5)
    assert res.auc == pytest.approx(j_auc, abs=1e-6)
    assert res.ap == pytest.approx(j_ap, abs=1e-6)


def test_scorer_answers_many_requests(ckpt_dir):
    """A Scorer prepares the graph once; every request gives the same
    scores, and the bf16 route stays within bf16 rounding of f32."""
    ds = synthetic_gad(**DS_KW)
    f32 = Scorer(ckpt_dir, ds, embedding_dim=N_H, spmm_impl="bcsr",
                 device="cpu")
    assert isinstance(f32.trainer.adj, BCSRGraph)
    first = f32.score()
    for subset in ("test", "val", "all"):
        again = f32.score(subset)
        np.testing.assert_array_equal(again.scores, first.scores)
    bf16 = Scorer(ckpt_dir, ds, embedding_dim=N_H, spmm_impl="bcsr",
                  spmm_dtype="bfloat16", device="cpu")
    assert bf16.trainer.adj.tiles.values.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.score().scores, first.scores,
                               rtol=2e-2, atol=2e-2)


def test_score_without_checkpoint_uses_seeded_init(tmp_path):
    ds = synthetic_gad(**DS_KW)
    a = score_dataset(str(tmp_path), ds, embedding_dim=N_H, device="cpu")
    b = score_dataset(str(tmp_path), ds, embedding_dim=N_H, device="cpu")
    assert a.step is None
    np.testing.assert_array_equal(a.scores, b.scores)
    assert np.all(np.isfinite(a.scores)) and a.scores.shape == (300,)


def test_cli_score_only_writes_scores(tmp_path, capsys):
    from ggad_tpu_torch.datasets.loaders import load_dataset

    ds = load_dataset("photo", synthetic_scale=0.04)
    ckpt = str(tmp_path / "ckpt")
    params = FullBatchTrainer(ds, embedding_dim=N_H, device="cpu").init(
        torch.Generator().manual_seed(11))
    Checkpointer(ckpt).save(7, {"params": params, "epoch": 7})
    out = tmp_path / "scores.npz"
    rc = cli_main(["--dataset", "photo", "--synthetic_scale", "0.04",
                   "--embedding_dim", str(N_H), "--checkpoint_dir", ckpt,
                   "--score_only", "--score_out", str(out),
                   "--spmm_impl", "bcsr", "--device", "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mode"] == "score_only" and rec["ckpt_step"] == 7
    d = np.load(out)
    assert d["scores"].shape == d["labels"].shape == (ds.n_nodes,)
    expect = score_dataset(ckpt, ds, embedding_dim=N_H, spmm_impl="coo",
                           device="cpu")
    np.testing.assert_allclose(d["scores"], expect.scores, rtol=1e-5,
                               atol=1e-5)
    assert rec["auc"] == pytest.approx(expect.auc, abs=1e-6)
    with pytest.raises(SystemExit):
        cli_main(["--checkpoint_dir", ckpt, "--device", "cpu"])


def test_cli_module_runs(tmp_path):
    out = tmp_path / "s.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "ggad_tpu_torch.cli", "--dataset",
         "synthetic", "--embedding_dim", str(N_H), "--score_only",
         "--checkpoint_dir", str(tmp_path / "fresh"), "--score_out",
         str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["ckpt_step"] is None
    assert np.load(out)["scores"].shape == (2000,)


def test_checkpointer_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None and ck.restore() is None
    for step in (1, 2, 4, 9):
        ck.save(step, {"params": {"w": torch.full((2,), float(step))},
                       "epoch": step})
    assert ck.steps() == [2, 4, 9]
    assert ck.restore()["params"]["w"].tolist() == [9.0, 9.0]
    assert ck.restore(4)["epoch"] == 4


def test_maybe_bcsr_routing():
    """Routing by the graph: a tile-dense graph takes BCSR under 'auto',
    a tile-sparse one the (not yet ported) ELL path; 'coo' keeps COO."""
    from ggad_tpu_torch.graph import from_coo, from_scipy

    dense = from_scipy(synthetic_gad(**DS_KW).adj, device="cpu")
    assert isinstance(maybe_bcsr(dense, "auto"), BCSRGraph)
    assert maybe_bcsr(dense, "coo") is dense
    n = 4000       # one edge per row, columns scattered: ~1 edge a tile
    sparse = from_coo(np.arange(n), np.random.default_rng(0).permutation(n),
                      None, n, device="cpu")
    with pytest.raises(NotImplementedError):
        maybe_bcsr(sparse, "auto")
    assert isinstance(maybe_bcsr(sparse, "bcsr"), BCSRGraph)
    with pytest.raises(ValueError):
        maybe_bcsr(dense, "xla")


def test_entry_points_need_a_device_without_cuda(monkeypatch, tmp_path):
    """Without a card and without ``device``, every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic_gad(**DS_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ggad_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        FullBatchTrainer(ds, embedding_dim=N_H)
    with pytest.raises(RuntimeError):
        score_dataset(str(tmp_path), ds, embedding_dim=N_H)
    with pytest.raises(RuntimeError):
        ggad_tpu_torch.from_scipy(ds.adj)
    with pytest.raises(RuntimeError):
        cli_main(["--score_only", "--checkpoint_dir", str(tmp_path)])


def test_serving_launches_no_kernel_on_cpu(ckpt_dir):
    bcsr_spmm.launches = 0
    Scorer(ckpt_dir, synthetic_gad(**DS_KW), embedding_dim=N_H,
           spmm_impl="bcsr", device="cpu").score()
    assert bcsr_spmm.launches == 0


ISOLATION = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
import ggad_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ggad_tpu_torch.__path__,
                                                "ggad_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "ggad_tpu" or m.startswith("ggad_tpu.")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_ggad_tpu():
    proc = subprocess.run([sys.executable, "-c", ISOLATION], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15     # every module was imported
