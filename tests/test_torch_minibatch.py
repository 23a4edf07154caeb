"""The minibatch (DGraph) path's pieces against ``ggad_tpu``: the sampler,
``MiniBatchGGAD`` and its losses, AdamW, the minibatch split and its
presets, the DGraph loader, the smoothed row normalization, the
thresholded metrics and the config grid.

JAX's sampling draws are recovered exactly: ``MiniBatchGGAD`` draws with
the key that ``model.apply(params, rngs={"sample": k}, method=lambda m:
m.make_rng("sample"))`` returns, split in two for the train branch as in
``sample_two_hop``. The port takes those draws as arguments. JAX's weights
go through ``interop.params_from_flax``. Tolerances: sampled ids and masks,
split arrays, normalized features and thresholded metrics exact;
``masked_mean`` 1e-6; forward outputs 1e-5; the four loss fields 1e-5;
gradients 1e-4 rel/abs; one AdamW update against ``optax.adamw`` 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import ggad_tpu.datasets.loaders as jax_loaders
import ggad_tpu.datasets.splits as jax_splits
import ggad_tpu.ops.metrics as jax_metrics
import ggad_tpu.train.config as jax_config
import ggad_tpu_torch.datasets.loaders as pt_loaders
import ggad_tpu_torch.datasets.splits as pt_splits
import ggad_tpu_torch.ops.metrics as pt_metrics
import ggad_tpu_torch.train.config as pt_config
from ggad_tpu.models.sage import MiniBatchGGAD as JaxMiniBatchGGAD
from ggad_tpu.models.sage import masked_mean as jax_masked_mean
from ggad_tpu.models.sage import minibatch_ggad_losses as jax_losses
from ggad_tpu.ops.normalize import row_normalize_smoothed as jax_smoothed
from ggad_tpu.sampler import neighbor as jax_neighbor
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import from_scipy
from ggad_tpu_torch.interop import params_from_flax, params_to_flax
from ggad_tpu_torch.models.sage import (
    MiniBatchGGAD,
    masked_mean,
    minibatch_ggad_losses,
)
from ggad_tpu_torch.ops.normalize import row_normalize_smoothed
from ggad_tpu_torch.sampler.neighbor import (
    NeighborTable,
    sample_neighbors,
    sample_two_hop,
)

F, EMB, K1, K2, B, N_ANOM = 12, 16, 4, 3, 20, 4


def small_adj(kind: str) -> sp.csr_matrix:
    """``graph``: a synthetic graph + I; ``zero_rows``: the same without
    self-loops and with rows 10..29 emptied; ``empty``: no edge at all."""
    if kind == "empty":
        return sp.csr_matrix((300, 300), dtype=np.float32)
    adj = synthetic_gad(n_nodes=300, avg_degree=8, feat_dim=F,
                        seed=2).adj.tocsr().astype(np.float32)
    if kind == "graph":
        return (adj + sp.eye(300, format="csr", dtype=np.float32)).tocsr()
    keep = np.ones(300, np.float32)
    keep[10:30] = 0.0
    adj = (sp.diags(keep) @ adj).tocsr()
    adj.sort_indices()
    return adj


def tables(adj):
    return (NeighborTable.from_scipy(adj, device="cpu"),
            jax_neighbor.NeighborTable.from_scipy(adj))


def batch_ids(seed=1, n=B):
    ids = np.random.default_rng(seed).integers(0, 300, n).astype(np.int32)
    ids[:3] = [10, 11, 29]       # zero-degree rows of the "zero_rows" graph
    return ids


def features(seed=0):
    return np.random.default_rng(seed).random((300, F)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def sample_key(jm, params, key):
    """The key ``MiniBatchGGAD.__call__`` draws its samples with."""
    return jm.apply(params, rngs={"sample": key},
                    method=lambda m: m.make_rng("sample"))


def two_hop_draws(key, b=B):
    r1, r2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(r1, (b, K1))),
            np.asarray(jax.random.uniform(r2, (b * K1, K2))))


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("kind", ["graph", "zero_rows", "empty"])
def test_sampled_ids_equal_jax(kind):
    pt, jt = tables(small_adj(kind))
    nodes = batch_ids()
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (B, K1)))
    jn, jmask = jax_neighbor.sample_neighbors(jt, jnp.asarray(nodes), K1, key)
    n, mask = sample_neighbors(pt, t(nodes), K1, t(u))
    assert n.dtype == torch.int32 and mask.dtype == torch.float32
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))

    u1, u2 = two_hop_draws(key)
    want = jax_neighbor.sample_two_hop(jt, jnp.asarray(nodes), K1, K2, key)
    got = sample_two_hop(pt, t(nodes), K1, K2, t(u1), t(u2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if kind != "graph":          # zero-degree rows return themselves, mask 0
        assert np.all(mask.numpy()[:3] == 0)
        np.testing.assert_array_equal(n.numpy()[:3], nodes[:3, None]
                                      .repeat(K1, 1))


def test_table_from_graph_and_degrees():
    adj = small_adj("zero_rows")
    pt, jt = tables(adj)
    g = NeighborTable.from_graph(from_scipy(adj, device="cpu"))
    nnz = adj.nnz
    assert g.indptr.dtype == g.indices.dtype == torch.int32
    np.testing.assert_array_equal(g.indptr.numpy(), np.asarray(jt.indptr))
    np.testing.assert_array_equal(g.indices.numpy()[:nnz],
                                  np.asarray(jt.indices))
    assert pt.n_nodes == g.n_nodes == jt.n_nodes == 300
    nodes = batch_ids()
    np.testing.assert_array_equal(
        pt.degrees_of(t(nodes)).numpy(),
        np.asarray(jt.degrees_of(jnp.asarray(nodes))))
    empty, _ = tables(small_adj("empty"))
    np.testing.assert_array_equal(empty.indices.numpy(), [0])


def test_sampling_stays_in_the_row():
    adj = small_adj("graph")
    pt, _ = tables(adj)
    nodes = np.arange(300, dtype=np.int32)
    u = torch.rand(300, 64, generator=torch.Generator().manual_seed(0))
    u[:, 0] = 0.0
    u[:, 1] = 1.0 - 2 ** -24       # the largest f32 draw below 1
    n, mask = sample_neighbors(pt, t(nodes), 64, u)
    dense = adj.toarray()
    assert np.all(dense[nodes[:, None], n.numpy()] != 0)
    np.testing.assert_array_equal(n.numpy()[:, 0], adj.indices[adj.indptr[:-1]])
    np.testing.assert_array_equal(n.numpy()[:, 1],
                                  adj.indices[adj.indptr[1:] - 1])
    assert np.all(mask.numpy() == 1)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("axis", [1, 2])
def test_masked_mean(axis):
    rng = np.random.default_rng(axis)
    x = rng.normal(size=(6, 5, 4, 3)).astype(np.float32)
    mask = (rng.random((6, 5, 4)) < 0.6).astype(np.float32)
    mask[0] = 0.0                  # an all-masked row divides by 1
    got = masked_mean(t(x), t(mask), axis).numpy()
    want = np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(mask),
                                      axis))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def jax_model(agg="gcn"):
    pt, jt = tables(small_adj("graph"))
    jm = JaxMiniBatchGGAD(emb_dim=EMB, fanout1=K1, fanout2=K2, agg=agg)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "sample": jax.random.PRNGKey(1)},
                     jnp.asarray(features()), jt,
                     jnp.asarray(batch_ids()), N_ANOM, True)
    port = MiniBatchGGAD(F, EMB, K1, K2, agg)
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, port, pt, jt


def test_params_keep_flax_names_and_layouts():
    jm, params, port, _, _ = jax_model()
    tree = jax.tree.map(np.asarray, params)
    assert set(port.state_dict()) == {"w_enc", "w_score", "fc_gen.weight"}
    back = params_to_flax(port.state_dict())
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, tree)
    fresh = MiniBatchGGAD(F, EMB, K1, K2,
                          generator=torch.Generator().manual_seed(0))
    for name, bound in [("w_enc", np.sqrt(6 / (F + EMB))),
                        ("w_score", np.sqrt(6 / (EMB + 1))),
                        ("fc_gen.weight", np.sqrt(6 / (2 * EMB)))]:
        w = fresh.state_dict()[name]
        assert 0 < w.abs().max() <= bound


@pytest.mark.parametrize("agg", ["gcn", "mean"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(agg, train):
    jm, params, port, pt, jt = jax_model(agg)
    nodes = batch_ids(seed=3)
    key = jax.random.PRNGKey(11)
    skey = sample_key(jm, params, key)
    if train:
        u1, u2 = two_hop_draws(skey)
    else:
        u1, u2 = np.asarray(jax.random.uniform(skey, (B, K1))), None
    n_anom = N_ANOM if train else 0
    want = jm.apply(params, jnp.asarray(features()), jt, jnp.asarray(nodes),
                    n_anom, train, rngs={"sample": key})
    with torch.no_grad():
        got = port(t(features()), pt, t(nodes), n_anom, train, u1=t(u1),
                   u2=None if u2 is None else t(u2))
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("agg", ["gcn", "mean"])
def test_one_step_losses_and_grads_match_jax(agg):
    jm, params, port, pt, jt = jax_model(agg)
    nodes = batch_ids(seed=4)
    key = jax.random.PRNGKey(12)
    u1, u2 = two_hop_draws(sample_key(jm, params, key))

    def loss_fn(p):
        out = jm.apply(p, jnp.asarray(features()), jt, jnp.asarray(nodes),
                       N_ANOM, True, rngs={"sample": key})
        losses = jax_losses(out, N_ANOM)
        return losses.total, losses

    (_, want), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    got = minibatch_ggad_losses(
        port(t(features()), pt, t(nodes), N_ANOM, True, u1=t(u1), u2=t(u2)),
        N_ANOM)
    got.total.backward()
    for name, a, b in zip(got._fields, got, want):
        assert a.item() == pytest.approx(float(b), rel=1e-5, abs=1e-5), name
    jg = params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        torch.testing.assert_close(p.grad, jg[name], rtol=1e-4, atol=1e-4)


def test_adamw_update_matches_optax():
    """One AdamW update from the same weights and gradients: torch's
    ``AdamW`` against ``optax.adamw`` (lr 1e-3, weight decay 0.007)."""
    jm, params, port, _, _ = jax_model()
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    tx = optax.adamw(1e-3, weight_decay=0.007)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = params_from_flax(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates)))
    opt = torch.optim.AdamW(port.parameters(), lr=1e-3, weight_decay=0.007)
    g = params_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in port.named_parameters():
        p.grad = g[name].clone()
    opt.step()
    for name, p in port.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------- splits and loaders
@pytest.mark.parametrize("name", [
    *jax_splits.MINIBATCH_SPLIT_PRESETS, "synthetic", "synthetic_dgraphfin",
    "synthetic_Amazon", "t_finance", "tf_finace", "tsocial_gad"])
def test_minibatch_split_for_bit_identical(name):
    rng = np.random.default_rng(len(name))
    labels = (rng.random(5000) < 0.05).astype(np.int64)
    assert (pt_splits.minibatch_split_preset_name(name)
            == jax_splits.minibatch_split_preset_name(name))
    a = pt_splits.minibatch_split_for(name, labels, seed=3, test_ratio=0.67)
    b = jax_splits.minibatch_split_for(name, labels, seed=3, test_ratio=0.67)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    if name in ("dgraphfin", "synthetic_dgraphfin"):
        # 20% of the real anomalies contaminate the train set
        assert pt_splits.minibatch_split_preset_name(name) == "dgraphfin"
        assert a[3][a[0]].sum() == int(labels.sum() * 0.2)
    if name == "amazon":
        assert min(map(np.min, a[:3])) >= 3305


@pytest.mark.parametrize("kw", [
    {}, dict(seeds_in_train=True, pseudo_anomaly_frac=0.1),
    dict(contamination_frac=0.2, labeled_rate=0.5, index_start=40)])
def test_minibatch_split_bit_identical(kw):
    labels = (np.random.default_rng(9).random(3000) < 0.08).astype(np.int64)
    for x, y in zip(pt_splits.minibatch_split(labels, seed=5, **kw),
                    jax_splits.minibatch_split(labels, seed=5, **kw)):
        np.testing.assert_array_equal(x, y)
    assert pt_splits.MINIBATCH_SPLIT_PRESETS == \
        jax_splits.MINIBATCH_SPLIT_PRESETS
    assert pt_splits._SPLIT_NAME_ALIASES == jax_splits._SPLIT_NAME_ALIASES


def test_load_dgraphfin_matches(tmp_path):
    rng = np.random.default_rng(0)
    n = 120
    ei = rng.integers(0, n, (2, 500))
    np.savez(tmp_path / "dgraphfin.npz", x=rng.random((n, 17)),
             y=rng.integers(0, 4, n), edge_index=ei.T)
    a = pt_loaders.load_dgraphfin(data_dir=str(tmp_path))
    b = jax_loaders.load_dgraphfin(data_dir=str(tmp_path))
    assert (a[0] != b[0]).nnz == 0 and a[0].diagonal().min() == 1.0
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    da = pt_loaders.load_dataset("dgraphfin", data_dir=str(tmp_path))
    db = jax_loaders.load_dataset("dgraphfin", data_dir=str(tmp_path))
    assert (da.adj != db.adj).nnz == 0 and da.adj.diagonal().max() == 0
    for f in ("features", "ano_labels", "idx_train", "normal_label_idx",
              "abnormal_label_idx"):
        np.testing.assert_array_equal(getattr(da, f), getattr(db, f))


def test_row_normalize_smoothed_exact():
    rng = np.random.default_rng(2)
    x = rng.random((50, 7)).astype(np.float32)
    x[3] = 0.0
    x[4] = -0.01 / 7               # rowsum + 0.01 == 0: the row stays 0
    got = row_normalize_smoothed(x)
    np.testing.assert_array_equal(got, jax_smoothed(x))
    assert got.dtype == np.float32


# -------------------------------------------------------- metrics, config
@pytest.mark.parametrize("case", ["mixed", "all_negative_preds",
                                  "one_class"])
def test_thresholded_metrics_exact(case):
    rng = np.random.default_rng(4)
    labels = (rng.random(500) < 0.1).astype(np.int64)
    probs = rng.random(500)
    if case == "all_negative_preds":
        probs *= 0.3
    if case == "one_class":
        labels[:] = 0
    for thres in (0.4, 0.5):
        pa = pt_metrics.prob_to_pred(probs, thres)
        pb = jax_metrics.prob_to_pred(probs, thres)
        np.testing.assert_array_equal(pa, pb)
        assert pt_metrics.f1_scores(labels, pa) == \
            jax_metrics.f1_scores(labels, pb)
        ca = pt_metrics.confusion(labels, pa)
        np.testing.assert_array_equal(ca, jax_metrics.confusion(labels, pb))
        assert pt_metrics.gmean_from_confusion(ca) == \
            jax_metrics.gmean_from_confusion(ca)


def test_grid_and_multi_run_match_jax():
    cfg = dict(pt_config.DEFAULT_CONFIG, seed=[1, 2, 3], lr=[1e-3, 1e-2],
               emb_size=8)
    assert pt_config.DEFAULT_CONFIG == jax_config.DEFAULT_CONFIG
    assert pt_config.METRIC_KEYS == jax_config.METRIC_KEYS
    assert pt_config.grid(cfg) == jax_config.grid(cfg)
    assert pt_config.grid({"a": 1}) == jax_config.grid({"a": 1})
    assert pt_config.run_name(cfg, []) == jax_config.run_name(cfg, [])

    def stub(cnf):
        return {"auc": cnf["seed"] / 10 + cnf["lr"], "f1_macro": cnf["seed"],
                "gmean": 0.5}

    assert pt_config.multi_run(cfg, stub, verbose=False) == \
        jax_config.multi_run(cfg, stub, verbose=False)
    one = dict(cfg, seed=4, lr=0.1)
    assert pt_config.multi_run(one, stub, verbose=False) == \
        jax_config.multi_run(one, stub, verbose=False)


def test_load_config_matches_jax(tmp_path):
    p = tmp_path / "cfg.yml"
    p.write_text("data_name: synthetic\nemb_size: 8\nseed:\n  - 1\n  - 2\n")
    assert pt_config.load_config(str(p)) == jax_config.load_config(str(p))
    empty = tmp_path / "empty.yml"
    empty.write_text("")
    assert pt_config.load_config(str(empty)) == pt_config.DEFAULT_CONFIG
