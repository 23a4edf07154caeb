"""The training slice against ``ggad_tpu.train.full_batch.FullBatchTrainer``.

Same dataset (the port's synthetic generator is a bit-identical copy),
same initial weights (the JAX init converted with ``interop``) and, for
one step, JAX's own noise draw recovered from an eval-mode apply with the
same rng as ``emb_abnormal - emb[seed]``. Tolerances:

  * one step, f32 routes (coo, bcsr-f32): all six ``GGADLosses`` fields to
    1e-5 and every parameter's gradient to 1e-4 rel/abs (true-f32 on both
    sides; sums in another order);
  * one step, bcsr-bf16 and ell-bf16: 1e-3 on both (bf16 tiles or tables
    and operands rounded at the same places on both sides; the rounded
    sums differ in order);
  * 5-epoch ``train()`` with ``noise_std=0`` (the trajectory pattern of
    ``tests/test_parity_trajectory.py``): losses and AUROC/AP to 1e-4
    (f32) and 1e-3 (bf16), with Adam and with AdamW.

The ELL routes force the sigma tables (``spmm_impl="ell"`` on both sides:
this graph is tile-dense, and JAX's ``"auto"`` takes ELL only on a TPU).
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
from ggad_tpu.train.losses import ggad_losses as jax_ggad_losses
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.interop import params_to_flax
from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
from ggad_tpu_torch.graph import Graph
from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm
from ggad_tpu_torch.ops.ell_spmm import ELLAffinitySubset, ELLGraph
from ggad_tpu_torch.ops.sddmm import AffinitySubset, TileAffinitySubset
from ggad_tpu_torch.train.full_batch import (
    FullBatchTrainer,
    train_with_retries,
)
from ggad_tpu_torch.utils.logging import JsonlLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_H = 24
DS_KW = dict(n_nodes=300, avg_degree=8, feat_dim=16, n_communities=3,
             anomaly_rate=0.1, seed=2)
ROUTES = {"coo": ("coo", "xla", "float32"),
          "bcsr-f32": ("bcsr", "pallas", "float32"),
          "bcsr-bf16": ("bcsr", "pallas", "bfloat16"),
          "ell-f32": ("ell", "ell", "float32"),
          "ell-bf16": ("ell", "ell", "bfloat16")}
# what prepare_training builds on each route: adj, seed_adj, aff_sub
BUILT = {"coo": (Graph, Graph, AffinitySubset),
         "bcsr-f32": (BCSRGraph, Graph, AffinitySubset),
         "bcsr-bf16": (BCSRGraph, Graph, TileAffinitySubset),
         "ell-f32": (ELLGraph, ELLGraph, ELLAffinitySubset),
         "ell-bf16": (ELLGraph, ELLGraph, ELLAffinitySubset)}
LOSS_FIELDS = ("total", "bce", "margin", "rec", "affinity_normal",
               "affinity_outlier")


@pytest.fixture(scope="module")
def jax_params():
    ds = jax_synthetic_gad(**DS_KW)
    tr = JaxTrainer(ds, num_epoch=0, embedding_dim=N_H, spmm_impl="xla")
    params, _ = tr.init(jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, params)


def port_trainer(route, params, **kw):
    impl, _, dtype = ROUTES[route]
    return FullBatchTrainer(synthetic_gad(**DS_KW), embedding_dim=N_H,
                            spmm_impl=impl, spmm_dtype=dtype,
                            initial_params=params, device="cpu", **kw)


def jax_trainer(route, params, **kw):
    _, impl, dtype = ROUTES[route]
    return JaxTrainer(jax_synthetic_gad(**DS_KW), embedding_dim=N_H,
                      spmm_impl=impl, spmm_dtype=dtype,
                      initial_params=params, **kw)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_step_losses_and_grads_match_jax(jax_params, route):
    tol = 1e-3 if route.endswith("bf16") else None
    kw = dict(noise_mean=0.02, noise_std=0.01, pos_weight=2.0)
    jt = jax_trainer(route, jax_params, **kw)
    rng = jax.random.PRNGKey(7)
    j_eval = jt.model.apply(jax_params, jt.adj, jt.features, jt.seed_idx,
                            jt.normal_idx, train=False, ax=jt.ax,
                            rngs={"noise": rng})
    noise = (np.asarray(j_eval.emb_abnormal)
             - np.asarray(j_eval.emb)[np.asarray(jt.seed_idx)])

    def loss_fn(p):
        out = jt.model.apply(p, jt.adj, jt.features, jt.seed_idx,
                             jt.normal_idx, train=True, seed_adj=jt.seed_adj,
                             ax=jt.ax, rngs={"noise": rng})
        losses = jax_ggad_losses(out, jt.raw_adj, jt.seed_idx, jt.normal_idx,
                                 pos_weight=2.0, aff_sub=jt.aff_sub)
        return losses.total, losses

    (_, j_losses), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax_params)

    pt = port_trainer(route, jax_params, **kw)
    pt.prepare_training()
    built = (pt.adj, pt.seed_adj, pt.aff_sub)
    assert [type(x) for x in built] == list(BUILT[route])
    pt.model.load_state_dict(pt.initial_state())
    losses = pt.compute_losses(torch.from_numpy(noise))
    losses.total.backward()
    for name in LOSS_FIELDS:
        np.testing.assert_allclose(
            getattr(losses, name).item(), float(getattr(j_losses, name)),
            rtol=tol or 1e-5, atol=tol or 1e-5, err_msg=name)
    grads = flat(params_to_flax({n: p.grad for n, p in
                                 pt.model.named_parameters()}))
    expect = flat(j_grads)
    assert grads.keys() == expect.keys()
    for k, g in expect.items():
        np.testing.assert_allclose(grads[k], g, rtol=tol or 1e-4,
                                   atol=tol or 1e-4, err_msg=k)


@pytest.mark.parametrize("route,weight_decay", [
    ("coo", 0.0), ("coo", 1e-2), ("bcsr-f32", 0.0), ("bcsr-f32", 1e-2),
    ("bcsr-bf16", 0.0), ("bcsr-bf16", 1e-2), ("ell-f32", 0.0),
    ("ell-bf16", 0.0)])
def test_train_trajectory_matches_jax(jax_params, route, weight_decay):
    """5 epochs of ``train()`` with Adam (weight_decay 0) and AdamW, every
    epoch logged, evaluated every second epoch."""
    tol = 1e-3 if route.endswith("bf16") else 1e-4
    kw = dict(num_epoch=5, log_every=1, eval_every=2, noise_mean=0.02,
              noise_std=0.0, lr=5e-3, weight_decay=weight_decay)
    j_res = jax_trainer(route, jax_params, **kw).train()
    p_res = port_trainer(route, jax_params, **kw).train()
    assert [r["epoch"] for r in p_res.history] == \
        [r["epoch"] for r in j_res.history]
    for p_rec, j_rec in zip(p_res.history, j_res.history):
        assert p_rec.keys() == j_rec.keys()
        for k in p_rec:
            assert p_rec[k] == pytest.approx(j_rec[k], rel=tol, abs=tol), \
                (p_rec["epoch"], k)
    assert p_res.final_auc == pytest.approx(j_res.final_auc, abs=tol)
    assert p_res.final_ap == pytest.approx(j_res.final_ap, abs=tol)


def test_train_auc_matches_jax(jax_params):
    jt = jax_trainer("coo", jax_params)
    pt = port_trainer("coo", jax_params)
    got = pt.train_auc(pt.initial_state())
    assert got == pytest.approx(jt.train_auc(jax_params), abs=1e-5)
    ds = pt.dataset
    scores = pt.eval_scores()
    from ggad_tpu_torch.ops.metrics import roc_auc
    assert got == pytest.approx(
        roc_auc(ds.ano_labels[ds.idx_train], scores[ds.idx_train]),
        abs=1e-5)


def assert_same_run(res, whole, skip):
    """Two CPU runs of the same steps: equal up to f32 reassociation
    (1e-5 rel, 1e-6 abs; the CPU's ``index_add`` sums in no fixed order,
    so two identical runs already differ in the last bits)."""
    for got, exp in zip(res.history, whole.history[skip:]):
        assert got.keys() == exp.keys()
        for k in got:
            assert got[k] == pytest.approx(exp[k], rel=1e-5, abs=1e-6), k
    assert res.final_auc == pytest.approx(whole.final_auc, abs=1e-6)
    for k, v in whole.params.items():
        torch.testing.assert_close(res.params[k], v, rtol=1e-5, atol=1e-6)


def test_resume_gives_the_uninterrupted_trajectory(tmp_path):
    """3 epochs with a checkpoint, then a new trainer resumes to 7: the
    same losses, metrics and weights as 7 epochs in one go, noise
    included (the generator state is restored)."""
    kw = dict(num_epoch=7, log_every=1, eval_every=2, noise_mean=0.02,
              noise_std=0.05, spmm_impl="bcsr", spmm_dtype="bfloat16",
              weight_decay=1e-2)
    ds = synthetic_gad(**DS_KW)
    whole = FullBatchTrainer(ds, embedding_dim=N_H, device="cpu",
                             **kw).train()
    ck = str(tmp_path / "ck")
    first = FullBatchTrainer(ds, embedding_dim=N_H, device="cpu",
                             checkpoint_dir=ck, **{**kw, "num_epoch": 3})
    first.train()
    resumed = FullBatchTrainer(ds, embedding_dim=N_H, device="cpu",
                               checkpoint_dir=ck, **kw).train()
    assert [r["epoch"] for r in resumed.history] == [3, 4, 5, 6]
    assert_same_run(resumed, whole, skip=3)
    from ggad_tpu_torch.train.checkpoint import Checkpointer
    state = Checkpointer(ck).restore()
    assert state["epoch"] == 6 and "opt_state" in state
    assert state["rng"].dtype == torch.uint8


def test_retries_resume_after_a_failure(tmp_path):
    """A failure at epoch 3 (raised from the logger) is retried: the new
    trainer resumes from the epoch-2 checkpoint and ends where an
    uninterrupted run ends."""
    kw = dict(num_epoch=6, log_every=1, eval_every=2, noise_mean=0.02,
              noise_std=0.05)
    ds = synthetic_gad(**DS_KW)
    whole = FullBatchTrainer(ds, embedding_dim=N_H, device="cpu",
                             **kw).train()
    calls = []

    def failing_logger(rec):
        if rec["epoch"] == 3 and not calls:
            calls.append(rec)
            raise RuntimeError("injected failure")

    res = train_with_retries(lambda: FullBatchTrainer(
        ds, embedding_dim=N_H, device="cpu", logger=failing_logger,
        checkpoint_dir=str(tmp_path), **kw), retries=1)
    assert calls and [r["epoch"] for r in res.history] == [3, 4, 5]
    assert_same_run(res, whole, skip=3)
    with pytest.raises(RuntimeError, match="injected"):
        calls.clear()
        train_with_retries(lambda: FullBatchTrainer(
            ds, embedding_dim=N_H, device="cpu", logger=failing_logger,
            **kw), retries=0)


def test_scan_steps_keep_the_log_boundaries(jax_params):
    """``scan_steps`` runs up to that many steps between reads of the
    loss, one after another: the JAX trainer's log epochs and losses
    (1e-4) for the same chunking, and the same weights as single steps."""
    kw = dict(num_epoch=9, log_every=3, eval_every=4, noise_mean=0.02,
              noise_std=0.0)
    j_res = jax_trainer("coo", jax_params, scan_steps=3, **kw).train()
    fused = port_trainer("coo", jax_params, scan_steps=3, **kw).train()
    one = port_trainer("coo", jax_params, **kw).train()
    assert [r["epoch"] for r in fused.history] == \
        [r["epoch"] for r in j_res.history] == [3, 8]
    assert [r["epoch"] for r in one.history] == [0, 3, 4, 6, 8]
    for p_rec, j_rec in zip(fused.history, j_res.history):
        for k in p_rec:
            assert p_rec[k] == pytest.approx(j_rec[k], rel=1e-4, abs=1e-4)
    for k, v in one.params.items():
        torch.testing.assert_close(fused.params[k], v, rtol=1e-5, atol=1e-6)


def test_train_launches_no_kernel_on_cpu():
    """CPU tensors take the plain versions on every route of the step."""
    bcsr_spmm.launches = 0
    bcsr_sddmm_colsum.launches = 0
    res = FullBatchTrainer(synthetic_gad(**DS_KW), embedding_dim=N_H,
                           spmm_impl="bcsr", spmm_dtype="bfloat16",
                           num_epoch=2, train_auc_every=1,
                           device="cpu").train()
    assert np.isfinite(res.history[-1]["loss"])
    assert bcsr_spmm.launches == 0 and bcsr_sddmm_colsum.launches == 0


def test_cli_trains_and_logs(tmp_path, capsys):
    log = tmp_path / "log.jsonl"
    ck = tmp_path / "ck"
    rc = cli_main(["--dataset", "synthetic", "--synthetic_scale", "0.15",
                   "--embedding_dim", str(N_H), "--num_epoch", "4",
                   "--eval_every", "2", "--train_auc_every", "2",
                   "--negsamp_ratio", "2", "--mean", "0.02", "--var",
                   "0.01", "--weight_decay", "0.01", "--scan_steps", "2",
                   "--log_jsonl", str(log), "--checkpoint_dir", str(ck),
                   "--retries", "1", "--spmm_impl", "bcsr", "--device",
                   "cpu"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["model"] == "ggad" and 0.0 <= rec["auc"] <= 1.0
    # two steps between reads: the chunk ends at epoch 1, then at 3 (the
    # JAX trainer's boundaries), and only the last epoch is logged
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [3]
    assert {"train_auc", "auc", "loss", "ts"} <= lines[0].keys()
    assert sorted(os.listdir(ck)) == ["ckpt_3.pt"]
    # a trained checkpoint serves
    rc = cli_main(["--dataset", "synthetic", "--synthetic_scale", "0.15",
                   "--embedding_dim", str(N_H), "--checkpoint_dir", str(ck),
                   "--score_only", "--spmm_impl", "bcsr", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ckpt_step"] == 3 and out["auc"] == pytest.approx(rec["auc"])


def test_cli_module_trains_photo_shaped():
    proc = subprocess.run(
        [sys.executable, "-m", "ggad_tpu_torch.cli", "--dataset", "photo",
         "--synthetic_scale", "0.05", "--embedding_dim", "64",
         "--num_epoch", "4", "--eval_every", "2", "--device", "cpu",
         "--spmm_impl", "bcsr"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["dataset"] == "synthetic_photo" and np.isfinite(rec["auc"])
    assert any(x.startswith("epoch    2  AUROC") for x in lines)


def test_jsonl_logger_appends(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    for rec in ({"epoch": 0, "loss": 1.5}, {"epoch": 1, "ts": 5.0}):
        lg = JsonlLogger(str(path))
        lg.log(rec)
        lg.close()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert recs[0]["loss"] == 1.5 and "ts" in recs[0]
    assert recs[1] == {"epoch": 1, "ts": 5.0}
