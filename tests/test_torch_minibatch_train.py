"""``MiniBatchTrainer`` and the CLI's minibatch routes against
``ggad_tpu.train.minibatch.MiniBatchTrainer``.

The same graph, split and initial weights (JAX's init through
``interop``), and JAX's own draws: the port's ``draws`` source replays
JAX's key chain (``PRNGKey(seed)`` → split → init key; each epoch split →
step key → ``split(step_key, num_batches)``; scoring ``PRNGKey(1234)`` →
``split(rng, n_chunks)``), each key turned into the sampler's key as
``MiniBatchGGAD.__call__`` does. The host's batch ids come from the same
numpy calls on both sides. Tolerances: each epoch's last-step losses, the
validation AUROC/AP and the test AUROC/AP 1e-4; the best epoch equal; the
test F1/G-mean equal on the nodes whose probabilities lie farther than
1e-5 from ``thres`` (a threshold flip inside the tolerance is no fault);
the pools and batch ids exact; scores 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ggad_tpu.datasets.splits import minibatch_split_for as jax_split_for
from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.ops import metrics as jax_metrics
from ggad_tpu.train.minibatch import MiniBatchTrainer as JaxTrainer
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.ops import metrics as pt_metrics
from ggad_tpu_torch.train import minibatch as pt_minibatch
from ggad_tpu_torch.train.checkpoint import Checkpointer
from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

DS_KW = dict(n_nodes=300, avg_degree=8, feat_dim=12, seed=2)
TR_KW = dict(emb_dim=16, fanout1=4, fanout2=3, batch_size=16,
             n_anom_per_batch=4, num_batches=5, num_epochs=3,
             valid_epochs=1, eval_batch=64, seed=3)
LOSS_KEYS = ("loss", "loss_cls", "loss_constraint", "loss_rec")
METRIC_KEYS = ("auc", "ap", "f1_macro", "f1_pos", "f1_neg", "gmean")
# the records of ggad_tpu.cli's minibatch routes (baselines.py:597-604,
# cli.py:225-234)
CLI_KEYS = {"model", "dataset", "best_val_auc", "best_epoch",
            "wall_time_s", *(f"test_{k}" for k in METRIC_KEYS)}
CONFIG_KEYS = {*METRIC_KEYS, "best_val_auc"}
MULTI_RUN_KEYS = {"n", *(f"{k}_{s}" for k in ("f1_macro", "f1_pos",
                                              "f1_neg", "auc", "gmean")
                         for s in ("mean", "std"))}


def trainer_inputs(pkg_synthetic, split_for):
    ds = pkg_synthetic(**DS_KW)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = split_for(
        ds.name, ds.ano_labels, seed=TR_KW["seed"])
    return dict(adj=adj, features=ds.features, labels=labels,
                idx_train=idx_train, idx_anomaly=idx_anom,
                idx_valid=idx_valid, idx_test=idx_test)


def jax_trainer(**kw):
    return JaxTrainer(**trainer_inputs(jax_synthetic_gad, jax_split_for),
                      **{**TR_KW, **kw})


def port_trainer(**kw):
    from ggad_tpu_torch.datasets.splits import minibatch_split_for
    return MiniBatchTrainer(**trainer_inputs(synthetic_gad,
                                             minibatch_split_for),
                            **{**TR_KW, "device": "cpu", **kw})


class JaxDraws:
    """The port's draw source replaying JAX's key chain for a trainer
    ``jt`` with parameters ``params``."""

    def __init__(self, jt, params):
        self.jt, self.params = jt, params
        self.train = []
        rng = jax.random.PRNGKey(jt.seed)
        rng, _ = jax.random.split(rng)                 # the init key
        b = jt.batch_size + jt.n_anom_per_batch
        for _ in range(jt.num_epochs):
            rng, step_rng = jax.random.split(rng)
            u1, u2 = [], []
            for key in jax.random.split(step_rng, jt.num_batches):
                r1, r2 = jax.random.split(self.sample_key(key))
                u1.append(jax.random.uniform(r1, (b, jt.fanout1)))
                u2.append(jax.random.uniform(
                    r2, (b * jt.fanout1, jt.fanout2)))
            self.train += [np.stack(u1), np.stack(u2)]

    def sample_key(self, key):
        return self.jt.model.apply(self.params, rngs={"sample": key},
                                   method=lambda m: m.make_rng("sample"))

    def __call__(self, shape):
        if shape[1:] == (self.jt.eval_batch, self.jt.fanout1):
            keys = jax.random.split(jax.random.PRNGKey(1234), shape[0])
            return np.stack([jax.random.uniform(self.sample_key(k),
                                                shape[1:]) for k in keys])
        u = self.train.pop(0)
        assert u.shape == shape
        return u


@pytest.fixture(scope="module")
def both_runs():
    jt = jax_trainer()
    params, _ = jt.init(jax.random.split(jax.random.PRNGKey(jt.seed))[1])
    params = jax.tree.map(np.asarray, params)
    jres = jt.train()
    pt = port_trainer(initial_params=params, draws=JaxDraws(jt, params))
    pres = pt.train()
    return jt, jres, pt, pres


def test_train_losses_match_jax(both_runs):
    _, jres, _, pres = both_runs
    assert len(pres.history) == len(jres.history) == TR_KW["num_epochs"]
    for a, b in zip(pres.history, jres.history):
        assert a["epoch"] == b["epoch"]
        for k in LOSS_KEYS:
            assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-4), k


def test_train_val_metrics_match_jax(both_runs):
    _, jres, _, pres = both_runs
    for a, b in zip(pres.history, jres.history):
        assert ("val_auc" in a) == ("val_auc" in b)
        for k in ("val_auc", "val_ap"):
            assert a[k] == pytest.approx(b[k], abs=1e-4), k
    assert pres.best_epoch == jres.best_epoch
    assert pres.best_val_auc == pytest.approx(jres.best_val_auc, abs=1e-4)


def test_train_test_metrics_match_jax(both_runs):
    jt, jres, pt, pres = both_runs
    for k in ("auc", "ap"):
        assert pres.test_metrics[k] == pytest.approx(jres.test_metrics[k],
                                                     abs=1e-4), k
    # the thresholded metrics, on the nodes no rounding can flip
    p_port = pt.score_nodes(pres.best_params, pt.idx_test)
    p_jax = jt.score_nodes(jres.best_params, jt.idx_test)
    np.testing.assert_allclose(p_port, p_jax, rtol=1e-4, atol=1e-4)
    far = ((np.abs(p_port - pt.thres) > 1e-5)
           & (np.abs(p_jax - jt.thres) > 1e-5))
    labels = pt.labels[pt.idx_test][far]
    pa = pt_metrics.prob_to_pred(p_port[far], pt.thres)
    pb = jax_metrics.prob_to_pred(p_jax[far], jt.thres)
    np.testing.assert_array_equal(pa, pb)
    assert pt_metrics.f1_scores(labels, pa) == \
        jax_metrics.f1_scores(labels, pb)
    assert pt_metrics.gmean_from_confusion(pt_metrics.confusion(
        labels, pa)) == jax_metrics.gmean_from_confusion(
            jax_metrics.confusion(labels, pb))
    assert set(pres.test_metrics) == set(jres.test_metrics)
    assert pres.wall_time_s >= pres.train_time_s > 0


@pytest.mark.parametrize("rows_per_pass", [64, 1 << 16])
def test_score_nodes_matches_jax(rows_per_pass, monkeypatch):
    """Scores of 150 ids (three chunks of 64, the last padded), in one
    pass or one chunk a pass, each chunk with JAX's draw."""
    monkeypatch.setattr(pt_minibatch, "EVAL_ROWS_PER_PASS", rows_per_pass)
    jt = jax_trainer()
    params, _ = jt.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    pt = port_trainer(draws=JaxDraws(jt, params))
    ids = np.random.default_rng(0).integers(0, 300, 150)
    want = jt.score_nodes(params, ids)
    from ggad_tpu_torch.interop import params_from_flax
    got = pt.score_nodes(params_from_flax(params), ids)
    assert got.shape == (150,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pt.model.load_state_dict(params_from_flax(params))
    np.testing.assert_array_equal(pt.score_nodes(None, ids), got)


def test_pools_and_batch_ids_match_jax():
    jt, pt = jax_trainer(), port_trainer()
    np.testing.assert_array_equal(pt._train_pool, jt._train_pool)
    np.testing.assert_array_equal(pt._anom_pool, jt._anom_pool)
    assert pt._train_pool.dtype == pt._anom_pool.dtype == np.int32
    np.testing.assert_array_equal(pt.features, jt.features)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        got = pt.draw_batches(rng_a)
        train_ids = rng_b.choice(jt._train_pool, size=(5, 16), replace=True)
        anom_ids = rng_b.choice(jt._anom_pool, size=(5, 4), replace=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate([train_ids, anom_ids], axis=1))


def test_own_draws_are_seeded_and_shaped():
    """Without a draw source the trainer draws from its generators: the
    same seed gives the same run; each epoch asks for its two draws at
    once."""
    shapes = []
    a = port_trainer(num_epochs=2).train()
    b = port_trainer(num_epochs=2).train()
    assert a.history == b.history
    for x, y in zip(a.params.values(), b.params.values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)

    tr = port_trainer(num_epochs=1, draws=lambda s: shapes.append(s)
                      or torch.rand(s))
    tr.train()
    assert shapes[:2] == [(5, 20, 4), (5, 80, 3)]
    n_valid = -(-len(tr.idx_valid) // 64)
    assert shapes[2:] == [(n_valid, 64, 4), (-(-len(tr.idx_test) // 64),
                                             64, 4)]


def test_best_checkpoint_is_written_and_restores(tmp_path):
    tr = port_trainer(checkpoint_dir=str(tmp_path))
    res = tr.train()
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == res.best_epoch
    state = ck.restore()
    assert state["metrics"]["val_auc"] == pytest.approx(res.best_val_auc)
    again = port_trainer(initial_params=state["params"])
    ids = tr.idx_test
    np.testing.assert_array_equal(
        again.score_nodes(None, ids),
        tr.score_nodes(res.best_params, ids))


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ggad_tpu_torch.datasets.splits import minibatch_split_for
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniBatchTrainer(**trainer_inputs(synthetic_gad,
                                          minibatch_split_for))


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_ggad_minibatch(capsys):
    rc = cli_main(["--dataset", "synthetic", "--model", "ggad-minibatch",
                   "--num_epoch", "1", "--device", "cpu"])
    assert rc == 0
    rec = last_json(capsys)
    assert set(rec) == CLI_KEYS
    assert rec["model"] == "ggad-minibatch" and rec["best_epoch"] == 0
    with pytest.raises(SystemExit):
        cli_main(["--model", "ggad-minibatch", "--score_only",
                  "--checkpoint_dir", "x", "--device", "cpu"])


@pytest.mark.parametrize("multi", [False, True])
def test_cli_config(multi, tmp_path, capsys):
    p = tmp_path / "cfg.yml"
    p.write_text("data_name: synthetic\nemb_size: 8\nbatch_size: 16\n"
                 "num_epochs: 2\nvalid_epochs: 1\nseed:\n  - 1\n  - 2\n")
    args = ["--config", str(p), "--num_epoch", "1", "--device", "cpu"]
    rc = cli_main(args + (["--multi_run"] if multi else []))
    assert rc == 0
    rec = last_json(capsys)
    assert set(rec) == (MULTI_RUN_KEYS if multi else CONFIG_KEYS)
    if multi:
        assert rec["n"] == 2
