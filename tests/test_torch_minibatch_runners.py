"""The minibatch baselines' runners and CLI routes against
``ggad_tpu.train.baselines``: ``run_minibatch_recon`` (DOMINANT-mb,
AnomalyDAE-mb, AEGIS-mb) and ``run_minibatch_classifier`` (GraphSAGE,
PC-GNN).

The port's runs start from JAX's initial weights and replay JAX's key
chain through their ``draws`` source: ``PRNGKey(seed)`` → (AEGIS: a split
for the noise key) → ``split(rng, 3)`` for init and sample → one split a
step; scoring from ``PRNGKey(999)`` (recon) or ``PRNGKey(4321)``
(classifiers), one split a chunk; each key turned into the sampler's as
the JAX modules do. AEGIS-mb takes JAX's noise table. The host's batch
ids come from the same numpy calls. Tolerances: batch ids exact; the
first three steps' losses against a JAX step built here from
``ggad_tpu``'s modules and ``optax`` 1e-4; the returned AUROC/AP (and best
validation AUROC) against JAX's runner 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp

from ggad_tpu.datasets.splits import minibatch_split
from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.models.pcgnn import PCGNN as JaxPCGNN
from ggad_tpu.models.pcgnn import pcgnn_loss as jax_pcgnn_loss
from ggad_tpu.models.sage import GraphSAGEClassifier as JaxSage
from ggad_tpu.models.sage_recon import MiniBatchAEGIS as JaxAEGIS
from ggad_tpu.models.sage_recon import MiniBatchRecon as JaxRecon
from ggad_tpu.models.sage_recon import aegis_mb_losses as jax_aegis_losses
from ggad_tpu.sampler.neighbor import NeighborTable as JaxTable
from ggad_tpu.train import baselines as jax_baselines
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.train import baselines as tb

SEED, EMB, BS, N_ANOM, NB, EPOCHS = 3, 16, 24, 8, 4, 2
RUN_KW = dict(emb_dim=EMB, batch_size=BS, num_batches=NB,
              num_epochs=EPOCHS, seed=SEED)
RECON_KEYS = {"test_auc", "test_ap", "wall_time_s"}
CLASSIFIER_KEYS = {"best_val_auc", *RECON_KEYS}
N_STEPS = 3


@pytest.fixture(scope="module")
def inputs():
    ds = jax_synthetic_gad(n_nodes=400, avg_degree=8, feat_dim=12,
                           anomaly_rate=0.08, n_relations=3, seed=5)
    adj = (ds.adj + sp.eye(ds.n_nodes, format="csr",
                           dtype=np.float32)).tocsr()
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split(
        ds.ano_labels, seed=0, pseudo_anomaly_frac=0.1)
    return dict(adj=adj, features=ds.features, labels=labels,
                idx_train=idx_train, idx_valid=idx_valid,
                idx_test=idx_test, idx_anomaly=idx_anom,
                relations=ds.relations)


def sample_key(model, params, key):
    return model.apply(params, rngs={"sample": key},
                       method=lambda m: m.make_rng("sample"))


class JaxChain:
    """JAX's keys for one runner, served to the port's ``draws`` by shape:
    an epoch's ``(num_batches, *shape)`` stacks in order, and a scoring
    call's ``(n_chunks, *shape)`` draws (1,024 rows a chunk) from
    ``PRNGKey(eval_seed)``."""

    def __init__(self, model, params, step_keys, b, forward_draws,
                 eval_seed):
        self.model, self.params = model, params
        self.forward_draws, self.eval_seed = forward_draws, eval_seed
        self.step_draws = [forward_draws(self.key(k), b) for k in step_keys]
        self.train = []
        for e in range(0, len(step_keys), NB):
            steps = self.step_draws[e:e + NB]
            self.train += [np.stack([s[j] for s in steps])
                           for j in range(len(steps[0]))]
        self.eval = []

    def key(self, k):
        return sample_key(self.model, self.params, k)

    def __call__(self, shape):
        if shape[1] % 1024 == 0 and shape[1] >= 1024:
            if not self.eval:
                key = jax.random.PRNGKey(self.eval_seed)
                chunks = []
                for _ in range(shape[0]):
                    key, sub = jax.random.split(key)
                    chunks.append(self.forward_draws(self.key(sub), 1024))
                self.eval = [np.stack([c[j] for c in chunks])
                             for j in range(len(chunks[0]))]
            u = self.eval.pop(0)
        else:
            u = self.train.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return u


def uniform_draws(fanout):
    def draws(key, b):
        return [np.asarray(jax.random.uniform(key, (b, fanout)))]
    return draws


def pcgnn_draws(n_rel, k1=16, k2=8):
    def draws(rng, b):
        out = []
        for _ in range(n_rel):
            rng, sub = jax.random.split(rng)
            r1, r2 = jax.random.split(sub)
            out += [np.asarray(jax.random.uniform(r1, (b, k1))),
                    np.asarray(jax.random.uniform(r2, (b * k1, k2)))]
        return out
    return draws


def step_keys(rng, n):
    keys = []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return keys


def jax_losses(loss_fn, params, tx, batches, keys, *extra):
    """The first ``N_STEPS`` losses of a JAX step built from the modules."""
    @jax.jit
    def step(p, opt, *args):
        loss, grads = jax.value_and_grad(loss_fn)(p, *args)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, loss

    opt, out = tx.init(params), []
    for i in range(N_STEPS):
        params, opt, loss = step(params, opt, batches[i], keys[i],
                                 *(e[i] for e in extra))
        out.append(float(loss))
    return out


@pytest.mark.parametrize("name", ["dominant-minibatch",
                                  "anomalydae-minibatch", "aegis-minibatch"])
def test_recon_runner_matches_jax(inputs, name):
    feats = jnp.asarray(inputs["features"], jnp.float32)
    table = JaxTable.from_scipy(inputs["adj"])
    rng = jax.random.PRNGKey(SEED)
    noise = None
    if name == "aegis-minibatch":
        model = JaxAEGIS(emb_dim=EMB)
        rng, nk = jax.random.split(rng)
        noise = jax.random.normal(nk, feats.shape)
        args = (feats, noise, table)
    else:
        model = JaxRecon(emb_dim=EMB,
                         pos_weighted=name == "anomalydae-minibatch")
        args = (feats, table)
    rng, ik, sk = jax.random.split(rng, 3)
    params = model.init({"params": ik, "sample": sk}, *args,
                        jnp.zeros(BS, jnp.int32))
    keys = step_keys(rng, EPOCHS * NB)
    chain = JaxChain(model, params, keys, BS, uniform_draws(16), 999)

    run = tb.MiniBatchReconRun(
        inputs["adj"], inputs["features"], inputs["labels"],
        inputs["idx_train"], inputs["idx_valid"], inputs["idx_test"],
        name=name, initial_params=jax.tree.map(np.asarray, params),
        draws=chain, noise_table=None if noise is None else np.array(
            noise), device="cpu", **RUN_KW)
    # batch ids: JAX's numpy calls (baselines.py:716-719)
    host = np.random.default_rng(SEED)
    pool = np.asarray(inputs["idx_train"], np.int64)
    want_ids = np.stack([host.choice(pool, BS, replace=True)
                         for _ in range(NB)])
    got_ids, no_labels = run.draw_batches(np.random.default_rng(SEED))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert no_labels is None

    got = run.train()
    want = jax_baselines.run_minibatch_recon(
        name, inputs["adj"], inputs["features"], inputs["labels"],
        inputs["idx_train"], inputs["idx_valid"], inputs["idx_test"],
        **RUN_KW)
    assert set(got) == set(want) == RECON_KEYS
    for k in ("test_auc", "test_ap"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert not chain.train

    def loss_fn(p, batch, key):
        if noise is not None:
            out = model.apply(p, feats, noise, table, batch,
                              rngs={"sample": key})
            ld, lg = jax_aegis_losses(out)
            return ld + lg
        x_rec = model.apply(p, feats, table, batch, rngs={"sample": key})
        return model.train_loss(x_rec, feats[batch])

    ref = jax_losses(loss_fn, params, optax.adam(1e-3),
                     jnp.asarray(want_ids, jnp.int32), keys)
    np.testing.assert_allclose([float(x) for x in run.losses[:N_STEPS]],
                               ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,relations", [("sage", False),
                                            ("pcgnn", False),
                                            ("pcgnn", True)])
def test_classifier_runner_matches_jax(inputs, name, relations):
    feats = jnp.asarray(inputs["features"], jnp.float32)
    table = JaxTable.from_scipy(inputs["adj"])
    rels = inputs["relations"] if relations else None
    if name == "pcgnn":
        n = inputs["adj"].shape[0]
        tb_ = [table] * 3 if rels is None else [JaxTable.from_scipy(
            r + sp.eye(n, format="csr", dtype=np.float32)) for r in rels]
        model, forward_draws = JaxPCGNN(emb_dim=EMB, n_relations=3), \
            pcgnn_draws(3)
    else:
        tb_, model, forward_draws = table, JaxSage(emb_dim=EMB, fanout=5), \
            uniform_draws(5)
    rng = jax.random.PRNGKey(SEED)
    rng, ik, sk = jax.random.split(rng, 3)
    params = model.init({"params": ik, "sample": sk}, feats, tb_,
                        jnp.zeros(BS + N_ANOM, jnp.int32))
    keys = step_keys(rng, EPOCHS * NB)
    chain = JaxChain(model, params, keys, BS + N_ANOM, forward_draws, 4321)
    kw = dict(RUN_KW, n_anom=N_ANOM, relations=rels)

    run = tb.MiniBatchClassifierRun(
        inputs["adj"], inputs["features"], inputs["labels"],
        inputs["idx_train"], inputs["idx_valid"], inputs["idx_test"],
        idx_anomaly=inputs["idx_anomaly"], name=name,
        initial_params=jax.tree.map(np.asarray, params), draws=chain,
        device="cpu", **kw)
    # batch ids and labels: JAX's numpy calls (baselines.py:836-852)
    labels, idx_train = inputs["labels"], inputs["idx_train"]
    train_pool = np.asarray([i for i in idx_train if labels[i] == 0])
    anom_pool = np.unique(np.asarray(list(inputs["idx_anomaly"]) + [
        i for i in idx_train if labels[i] == 1], np.int64))
    host = np.random.default_rng(SEED)
    want_ids = np.stack([np.concatenate([
        host.choice(train_pool, BS, replace=True),
        host.choice(anom_pool, N_ANOM, replace=len(anom_pool) < N_ANOM)])
        for _ in range(NB)])
    got_ids, got_y = run.draw_batches(np.random.default_rng(SEED))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_y.numpy(), labels[want_ids])

    got = run.train()
    want = jax_baselines.run_minibatch_classifier(
        name, inputs["adj"], inputs["features"], labels, idx_train,
        inputs["idx_anomaly"], inputs["idx_valid"], inputs["idx_test"],
        **kw)
    assert set(got) == set(want) == CLASSIFIER_KEYS
    for k in ("best_val_auc", "test_auc", "test_ap"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert not chain.train

    def loss_fn(p, batch, key, y):
        out = model.apply(p, feats, tb_, batch, rngs={"sample": key})
        if name == "pcgnn":
            return jax_pcgnn_loss(out, y)[0]
        logp = jax.nn.log_softmax(out, -1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    ref = jax_losses(loss_fn, params, optax.adamw(1e-3, weight_decay=0.007),
                     jnp.asarray(want_ids, jnp.int32), keys,
                     jnp.asarray(labels[want_ids], jnp.int32))
    np.testing.assert_allclose([float(x) for x in run.losses[:N_STEPS]],
                               ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["sage", "pcgnn", "dominant-minibatch",
                                  "anomalydae-minibatch", "aegis-minibatch"])
def test_cli_minibatch_baselines(name, capsys):
    """Each new ``--model`` trains on the DGraph-shaped fallback on the
    CPU and prints JAX's record keys (``baselines.py:606-622``)."""
    assert cli_main(["--model", name, "--dataset", "dgraphfin",
                     "--synthetic_scale", "0.002", "--num_epoch", "1",
                     "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = CLASSIFIER_KEYS if name in ("sage", "pcgnn") else RECON_KEYS
    assert set(rec) == keys | {"model", "dataset"}
    assert rec["model"] == name and rec["dataset"] == "synthetic_dgraphfin"
    assert all(np.isfinite(rec[k]) for k in keys)


@pytest.mark.parametrize("runner", ["recon", "classifier"])
def test_runners_need_a_card_unless_told_cpu(inputs, runner, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [inputs[k] for k in ("adj", "features", "labels", "idx_train",
                                "idx_valid", "idx_test")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if runner == "recon":
            tb.run_minibatch_recon("dominant-minibatch", *args, **RUN_KW)
        else:
            tb.run_minibatch_classifier(
                "sage", *args[:4], inputs["idx_anomaly"], *args[4:],
                **RUN_KW)
