"""The baseline zoo's ops, layers and models against ``ggad_tpu``.

Same numpy-seeded inputs and, for layers and models, JAX's own
parameters (mapped by ``interop.params_from_flax``) and noise. Values and
gradients (of a fixed random projection of the output) are held to 1e-5
rel/abs, except:

  * ``bce_probs`` at saturation: the values are exact (both clamp the log
    at -100) and the gradients at p = 0 and p = 1 are ±1e12, which f32
    holds to 1e-6 relative;
  * ``GATLayer`` gradients 1e-4: the segment max is not detached on either
    side and its gradient cancels only to rounding, as do the softmax's
    sums in another order;
  * the structure error and AnomalyDAE's scores 1e-4: row sums over up to
    N terms of order 1, in another order.

The split variants must give equal index arrays and features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggad_tpu.datasets import splits as jsplits
from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.graph import from_scipy as jax_from_scipy
from ggad_tpu.models import aegis as ja
from ggad_tpu.models import anomaly_dae as jdae
from ggad_tpu.models import dominant as jdom
from ggad_tpu.models import gaan as jgaan
from ggad_tpu.models import ocgnn as jocg
from ggad_tpu.nn import layers as jl
from ggad_tpu.ops import dense_blocks as jdb
from ggad_tpu.ops.bce import bce_probs as jax_bce
from ggad_tpu.ops.normalize import gcn_norm_graph as jax_gcn_norm
from ggad_tpu.ops.normalize import normalize_adj_reference as jax_norm_adj
from ggad_tpu_torch.datasets import splits as tsplits
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import from_scipy
from ggad_tpu_torch.interop import params_from_flax
from ggad_tpu_torch.models import aegis as ta
from ggad_tpu_torch.models import anomaly_dae as tdae
from ggad_tpu_torch.models import dominant as tdom
from ggad_tpu_torch.models import gaan as tgaan
from ggad_tpu_torch.models import ocgnn as tocg
from ggad_tpu_torch.nn import layers as tl
from ggad_tpu_torch.ops import dense_blocks as tdb
from ggad_tpu_torch.ops.bce import bce_probs
from ggad_tpu_torch.ops.normalize import gcn_norm_graph
from ggad_tpu_torch.ops.normalize import normalize_adj_reference

TOL = 1e-5
DS_KW = dict(n_nodes=150, avg_degree=6, feat_dim=24, n_communities=3,
             anomaly_rate=0.1, seed=3)


def t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def graphs():
    """(JAX adj, port adj, JAX raw, port raw, features): the normalised +I
    graph and A + I of a small synthetic dataset, padding edges
    included."""
    ds = synthetic_gad(**DS_KW)
    jadj, jraw = jax_norm_adj(jax_from_scipy(ds.adj))
    tadj, traw = normalize_adj_reference(from_scipy(ds.adj, device="cpu"))
    assert tadj.e_pad > tadj.n_edges          # padding edges present
    return jadj, tadj, jraw, traw, ds.features


def load(module, flax_params):
    module.load_state_dict(params_from_flax(flax_params))
    return module


# --------------------------------------------------------------------- bce
def test_bce_probs_values_and_grads_at_the_edges():
    p = np.array([0.0, 1e-30, 1e-8, 0.3, 0.5, 0.9, 1 - 1e-7, 1.0],
                 np.float32)
    for y in (0.0, 1.0):
        want = jax_bce(jnp.asarray(p), y)
        wgrad = jax.grad(lambda q: jnp.sum(jax_bce(q, y)))(jnp.asarray(p))
        tp = t(p, grad=True)
        got = bce_probs(tp, y)
        got.sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-6)
        assert np.isfinite(tp.grad.numpy()).all()
    assert float(bce_probs(t([0.0]), 1.0)) == 100.0    # saturated: log clamp


# ---------------------------------------------------------- dense blocks
@pytest.mark.parametrize("block", [64, 1024])
def test_blockwise_pair_reduce_values_and_grads(block):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((150, 12)).astype(np.float32) * 0.3
    w = rng.standard_normal(150).astype(np.float32)

    def jfn(e):
        return jdb.blockwise_pair_reduce(
            e, lambda s: jnp.square(jax.nn.sigmoid(s)), block=block)

    want, wgrad = jfn(emb), jax.grad(lambda e: jnp.sum(jfn(e) * w))(emb)
    te = t(emb, grad=True)
    got = tdb.blockwise_pair_reduce(te, tdb._sigmoid_sq, block=block)
    (got * t(w)).sum().backward()
    close(got, want)
    close(te.grad, wgrad)


def test_structure_and_attr_row_errors_values_and_grads(graphs):
    jadj, tadj, _, _, _ = graphs
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((150, 10)).astype(np.float32) * 0.4
    x = rng.standard_normal((150, 10)).astype(np.float32)
    w = rng.standard_normal(150).astype(np.float32)

    def jfn(e):
        return (jdb.sigmoid_structure_row_error(jadj, e, block=64)
                + jdb.attr_row_error(x, e))

    want, wgrad = jfn(emb), jax.grad(lambda e: jnp.sum(jfn(e) * w))(emb)
    te = t(emb, grad=True)
    got = (tdb.sigmoid_structure_row_error(tadj, te, block=64)
           + tdb.attr_row_error(t(x), te))
    (got * t(w)).sum().backward()
    close(got, want, 1e-4)
    close(te.grad, wgrad, 1e-4)


def test_gcn_norm_graph_exact(graphs):
    """Equal to an f32 numpy reference bit for bit (in-degrees over the
    binarised edges, 1/sqrt correctly rounded); JAX to 1 ulp, since XLA's
    CPU ``rsqrt`` is not correctly rounded (49 of the degrees 1..199 come
    out 1 ulp off)."""
    _, _, jraw, traw, _ = graphs
    want, got = jax_gcn_norm(jraw), gcn_norm_graph(traw)
    np.testing.assert_array_equal(got.row.numpy(), np.asarray(want.row))
    np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
    row, col, val = (a.numpy() for a in (traw.row, traw.col, traw.val))
    valid = (val != 0).astype(np.float32)
    deg = np.bincount(col, weights=valid,
                      minlength=traw.n_nodes).astype(np.float32)
    dinv = np.float32(1) / np.sqrt(deg)
    np.testing.assert_array_equal(got.val.numpy(),
                                  valid * dinv[row] * dinv[col])
    assert np.all(got.val.numpy()[got.n_edges:] == 0)
    np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val),
                               rtol=2.5e-7, atol=0)


# ---------------------------------------------------------------- layers
def test_gat_layer_with_padding_edges(graphs):
    jadj, tadj, _, _, _ = graphs
    rng = np.random.default_rng(2)
    x = rng.standard_normal((150, 16)).astype(np.float32)
    w = rng.standard_normal((150, 8)).astype(np.float32)
    mod = jl.GATLayer(8)
    params = mod.init(jax.random.PRNGKey(0), jadj, jnp.asarray(x))

    def jloss(p, xx):
        return jnp.sum(mod.apply(p, jadj, xx) * w)

    want = mod.apply(params, jadj, jnp.asarray(x))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    layer = load(tl.GATLayer(16, 8), params)
    tx = t(x, grad=True)
    got = layer(tadj, tx)
    (got * t(w)).sum().backward()
    close(got, want)
    close(tx.grad, gx, 1e-4)
    flat = params_from_flax(gp)
    for name, prm in layer.named_parameters():
        close(prm.grad, flat[name].numpy(), 1e-4)


def test_bilinear_discriminator_matches_jax():
    rng = np.random.default_rng(3)
    c = rng.standard_normal((9, 6)).astype(np.float32)
    h = rng.standard_normal((9, 5)).astype(np.float32)
    mod = jl.BilinearDiscriminator(negsamp_rounds=2)
    params = mod.init(jax.random.PRNGKey(1), c, h)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1, params)  # bias ≠ 0
    got = load(tl.BilinearDiscriminator(5, 6, negsamp_rounds=2), params)(
        t(c), t(h))
    assert got.shape == (27, 1)
    close(got, mod.apply(params, c, h))


@pytest.mark.parametrize("mode", ["avg", "max", "min", "weighted_sum"])
def test_readout_matches_jax(mode):
    rng = np.random.default_rng(4)
    seq = rng.standard_normal((3, 7, 5)).astype(np.float32)
    q = rng.standard_normal((3, 5)).astype(np.float32)
    close(tl.readout(t(seq), mode, t(q)), jl.readout(seq, mode, q))


def test_readout_rejects_unknown_modes():
    with pytest.raises(ValueError):
        tl.readout(torch.zeros(2, 3), "median")
    with pytest.raises(ValueError):
        tl.readout(torch.zeros(2, 3), "weighted_sum")


@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_pyg_mlp_train_mode_batch_norm(act):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 12)).astype(np.float32) * 3 + 1
    w = rng.standard_normal((40, 7)).astype(np.float32)
    mod = ja.PyGMLP(16, 7, act=act)
    params = mod.init(jax.random.PRNGKey(2), x)
    want = mod.apply(params, x)
    gx = jax.grad(lambda xx: jnp.sum(mod.apply(params, xx) * w))(x)
    mlp = load(ta.PyGMLP(12, 16, 7, act=act), params)
    tx = t(x, grad=True)
    got = mlp(tx)
    (got * t(w)).sum().backward()
    close(got, want)
    close(tx.grad, gx)
    assert not any(name.startswith("running") for name, _ in
                   mlp.named_buffers())


@pytest.mark.parametrize("act,n_params", [("prelu", 3), ("relu", 2),
                                          ("none", 2)])
def test_gcn_layer_acts_and_bias(graphs, act, n_params):
    jadj, tadj, _, _, features = graphs
    mod = jl.GCNLayer(9, act=act)
    params = mod.init(jax.random.PRNGKey(3), jadj, features)
    params = jax.tree.map(lambda a: np.asarray(a) - 0.05, params)
    layer = load(tl.GCNLayer(features.shape[1], 9, act=act), params)
    assert len(list(layer.parameters())) == n_params
    close(layer(tadj, t(features)), mod.apply(params, jadj, features))
    assert tl.GCNLayer(4, 4, use_bias=False).bias is None
    with pytest.raises(ValueError, match="unknown act"):
        tl.GCNLayer(4, 4, act="tanh")


# ---------------------------------------------------------------- models
@pytest.fixture(scope="module")
def noise():
    return np.random.default_rng(6).standard_normal(
        (DS_KW["n_nodes"], 16)).astype(np.float32)


def test_dominant_forward_and_structure_branch(graphs):
    jadj, tadj, jraw, traw, x = graphs
    jm = jdom.Dominant(n_h=20)
    params = jm.init(jax.random.PRNGKey(4), jadj, x)
    jgcn = jax_gcn_norm(jraw)
    want = jm.apply(params, jadj, x, gcn_adj=jgcn)
    model = load(tdom.Dominant(x.shape[1], 20), params)
    got = model(tadj, t(x))
    assert got.emb is None          # nothing reads it at weight 1.0
    close(got.x_rec, want.x_rec)
    close(got.scores, want.scores)
    close(model.embed(gcn_norm_graph(traw), t(x)), want.emb)
    # below weight 1.0 the structure error joins the score
    jm_s = jdom.Dominant(n_h=20, structure_weight=0.5)
    want_s = jm_s.apply(params, jadj, x, gcn_adj=jgcn)
    model_s = load(tdom.Dominant(x.shape[1], 20, 0.5), params)
    got_s = model_s(tadj, t(x), gcn_adj=gcn_norm_graph(traw))
    close(got_s.emb, want_s.emb)
    close(got_s.scores, want_s.scores, 1e-4)


def test_anomaly_dae_forward(graphs):
    jadj, tadj, _, _, x = graphs
    jm = jdae.AnomalyDAE(n_h=20)
    params = jm.init(jax.random.PRNGKey(5), jadj, x)
    want = jm.apply(params, jadj, x)
    got = load(tdae.AnomalyDAE(x.shape[1], 20), params)(tadj, t(x))
    close(got.emb, want.emb)
    close(got.x_rec, want.x_rec)
    close(got.scores, want.scores, 1e-4)


@pytest.mark.parametrize("use_warmup", [False, True])
def test_ocgnn_forward_loss_and_state(graphs, use_warmup):
    jadj, tadj, _, _, x = graphs
    jm = jocg.OCGNNEncoder(n_h=20)
    params = jm.init(jax.random.PRNGKey(6), jadj, x)
    emb = jm.apply(params, jadj, x)
    got_emb = load(tocg.OCGNNEncoder(x.shape[1], 20), params)(tadj, t(x))
    close(got_emb, emb)
    idx = np.arange(0, 150, 3)
    jst, tst = jocg.init_ocgnn_state(20), tocg.init_ocgnn_state(20)
    for _ in range(3):      # the warmup runs twice, then the state holds
        jl_, js, jst = jocg.ocgnn_loss(emb[idx], jst, use_warmup=use_warmup)
        tl_, ts, tst = tocg.ocgnn_loss(got_emb[idx], tst,
                                       use_warmup=use_warmup)
        close(tl_, jl_)
        close(ts, js)
        close(tst.center, jst.center)
        close(tst.radius, jst.radius)
        assert tst.warmup_left == int(jst.warmup_left)
    close(tocg.ocgnn_scores(got_emb, tst), jocg.ocgnn_scores(emb, jst))


def test_aegis_forward_losses_and_scores(graphs, noise):
    jadj, tadj, _, _, x = graphs
    jm = ja.AEGIS(n_h=20)
    key = jax.random.PRNGKey(7)
    params = jm.init({"params": key, "noise": key}, jadj, x)
    want = jm.apply(params, jadj, x, noise)
    got = load(ta.AEGIS(x.shape[1], 20), params)(tadj, t(x), t(noise))
    for field in ja.AEGISOutput._fields:
        close(getattr(got, field), getattr(want, field))
    idx = np.arange(0, 150, 4)
    for a, b in zip(ta.aegis_losses(got, t(x), torch.as_tensor(idx)),
                    ja.aegis_losses(want, x, idx)):
        close(a, b)
    close(ta.aegis_scores(got), ja.aegis_scores(want))


def test_gaan_forward_losses_and_scores(graphs, noise):
    jadj, tadj, _, _, x = graphs
    jm = jgaan.GAAN()
    key = jax.random.PRNGKey(8)
    params = jm.init({"params": key, "noise": key}, x)
    want = jm.apply(params, x, noise)
    got = load(tgaan.GAAN(x.shape[1]), params)(t(x), t(noise))
    for field in jgaan.GAANOutput._fields:
        close(getattr(got, field), getattr(want, field))
    mask = np.arange(150) % 2 == 0
    idx = np.flatnonzero(mask)
    np.testing.assert_array_equal(
        tgaan.train_edge_mask(tadj, torch.as_tensor(mask)).numpy(),
        np.asarray(jgaan.train_edge_mask(jadj, jnp.asarray(mask))))
    for a, b in zip(tgaan.gaan_losses(got, tadj, t(x), torch.as_tensor(mask),
                                      torch.as_tensor(idx)),
                    jgaan.gaan_losses(want, jadj, x, jnp.asarray(mask),
                                      idx)):
        close(a, b)
    close(tgaan.gaan_scores(got, t(x)), jgaan.gaan_scores(want, x))


# ---------------------------------------------------------------- splits
@pytest.mark.parametrize("add,remove", [(0.0, 0.0), (0.2, 0.0), (0.3, 0.1)])
@pytest.mark.parametrize("seed", [0, 5])
def test_reference_split_contamination_matches_jax(add, remove, seed):
    labels = jax_synthetic_gad(**DS_KW).ano_labels
    kw = dict(seed=seed, contamination_add_rate=add,
              contamination_remove_rate=remove)
    want, got = jsplits.reference_split(labels, **kw), \
        tsplits.reference_split(labels, **kw)
    for field in ("idx_train", "idx_val", "idx_test", "normal_label_idx",
                  "abnormal_label_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    if add:
        assert np.any(labels[got.normal_label_idx] == 1)


@pytest.mark.parametrize("rate", [0.05, 0.25])
def test_camouflage_features_match_jax(rate):
    ds = synthetic_gad(**DS_KW)
    got = tsplits.camouflage_features(ds.features, ds.ano_labels,
                                      ds.normal_label_idx, rate)
    want = jsplits.camouflage_features(ds.features, ds.ano_labels,
                                       ds.normal_label_idx, rate)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, ds.features)
