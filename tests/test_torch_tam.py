"""TAM's pieces against ``ggad_tpu.models.tam`` (and ``tam_split``).

Same numpy-seeded inputs and JAX's own parameters, draws and, for the
cut, distances. Tolerances:

  * ``tam_split``, ``transpose_permutation`` and the block-diagonal tile
    stores: exactly equal (the same numpy on the host);
  * ``nsgt_cut``: exactly equal over three sequential cuts, given JAX's
    ``dis`` (its mean and the thresholds are float sums whose order differs
    between XLA and torch; fed the same ``dis``, no threshold flips);
  * ``edge_feature_distance``, ``sym_normalize_vals`` (XLA's CPU ``rsqrt``
    is not correctly rounded) and ``minmax``: 1e-6 relative;
  * ``tam_loss``, the encoder and the block-diagonal product (values and
    gradients): 1e-5, sums of a few terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggad_tpu.datasets import splits as jsplits
from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.graph import add_self_loops as jax_add_self_loops
from ggad_tpu.graph import from_scipy as jax_from_scipy
from ggad_tpu.models import tam as jtam
from ggad_tpu.ops.ell_spmm import as_ell_graph as jax_as_ell_graph
from ggad_tpu_torch.datasets import splits as tsplits
from ggad_tpu_torch.graph import add_self_loops, from_scipy
from ggad_tpu_torch.interop import params_from_flax, params_to_flax
from ggad_tpu_torch.models import tam
from ggad_tpu_torch.ops import bcsr_spmm as pb
from ggad_tpu_torch.ops.ell_spmm import as_ell_graph

DS_KW = dict(n_nodes=300, avg_degree=8, feat_dim=16, anomaly_rate=0.08,
             seed=7)
N_H = 12
CUTS = 3


@pytest.fixture(scope="module")
def graphs():
    ds = jax_synthetic_gad(**DS_KW)
    jraw = jax_add_self_loops(jax_from_scipy(ds.adj))
    traw = add_self_loops(from_scipy(ds.adj, device="cpu"))
    return ds, jraw, traw


@pytest.fixture(scope="module")
def jax_cuts(graphs):
    """JAX's cut chain as ``run_tam`` draws it (``tam.py:402-415``): the
    distances, the transpose permutation, each cut's draw and values."""
    ds, jraw, _ = graphs
    x = jnp.asarray(ds.features)
    dis = jtam.edge_feature_distance(jraw, x)
    t_perm = jnp.asarray(jtam.transpose_permutation(jraw))
    rng = jax.random.PRNGKey(0)
    val, draws, vals = jraw.val, [], []
    for _ in range(CUTS):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(sub, (jraw.n_nodes,))))
        val = jtam.nsgt_cut(val, dis, jraw, t_perm, sub)
        vals.append(np.asarray(val))
    return np.asarray(dis), np.asarray(t_perm), draws, vals


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("rate", [0.08, 0.3])
def test_tam_split_equals_jax(seed, rate):
    labels = (np.random.default_rng(seed).random(500) < rate).astype(np.int64)
    want = jsplits.tam_split(labels, seed=seed)
    got = tsplits.tam_split(labels, seed=seed)
    for field in ("idx_train", "idx_val", "idx_test", "normal_label_idx",
                  "abnormal_label_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_edge_distance_and_transpose_permutation(graphs, jax_cuts):
    ds, jraw, traw = graphs
    dis, t_perm, _, _ = jax_cuts
    got = tam.edge_feature_distance(traw, t(ds.features))
    np.testing.assert_allclose(got.numpy(), dis, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tam.transpose_permutation(traw), t_perm)


def test_nsgt_cut_equals_jax_over_sequential_cuts(graphs, jax_cuts):
    """Given JAX's distances and draws, three sequential cuts give JAX's
    values exactly, and each cut removes edges."""
    _, _, traw = graphs
    dis, t_perm, draws, vals = jax_cuts
    val = traw.val
    for u, want in zip(draws, vals):
        new = tam.nsgt_cut(val, t(dis), traw, t(t_perm), t(u))
        np.testing.assert_array_equal(new.numpy(), want)
        assert new.sum() < val.sum()
        val = new


def test_cut_stack_orders_cuts_by_tree(graphs, jax_cuts):
    """``cut_stack`` chains each tree's cuts and lays the members out cut
    by cut (member c·n_tree + t), as ``tam.py:407-415``."""
    ds, _, traw = graphs
    _, _, draws, _ = jax_cuts
    x = t(ds.features)
    one = tam.cut_stack(traw, x, 2, 1, draws[:2])
    two = tam.cut_stack(traw, x, 1, 2, draws[:2])
    torch.testing.assert_close(one[0], two[0], rtol=0, atol=0)
    first_of_second_tree = tam.cut_stack(traw, x, 1, 1, draws[1:2])[0]
    torch.testing.assert_close(two[1], first_of_second_tree, rtol=0, atol=0)


def test_normalize_minmax_and_loss(graphs, jax_cuts):
    ds, jraw, traw = graphs
    _, _, _, vals = jax_cuts
    stack = np.stack(vals)
    want = np.asarray(jax.vmap(lambda v: jtam.sym_normalize_vals(v, jraw))(
        jnp.asarray(stack)))
    got = tam.sym_normalize_vals(t(stack), traw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tam.sym_normalize_vals(t(stack[1]), traw),
                               want[1], rtol=1e-6, atol=0)

    rng = np.random.default_rng(2)
    x = rng.normal(size=ds.n_nodes).astype(np.float32) * 3
    np.testing.assert_allclose(tam.minmax(t(x)).numpy(),
                               np.asarray(jtam.minmax(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)

    emb = rng.normal(size=(ds.n_nodes, 9)).astype(np.float32)
    nidx = ds.normal_label_idx
    jloss, jmsg = jtam.tam_loss(jnp.asarray(emb), jax_as_ell_graph(jraw),
                                jnp.asarray(nidx, jnp.int32))
    loss, msg = tam.tam_loss(t(emb), as_ell_graph(traw), t(nidx))
    np.testing.assert_allclose(msg.numpy(), np.asarray(jmsg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_encoder_matches_jax(graphs):
    ds, jraw, traw = graphs
    x = ds.features
    params = jtam.TAMEncoder(n_h=N_H).init(jax.random.PRNGKey(3), jraw,
                                           jnp.asarray(x))
    want = np.asarray(jtam.TAMEncoder(n_h=N_H).apply(params, jraw,
                                                     jnp.asarray(x)))
    enc = tam.TAMEncoder(ds.feat_dim, N_H)
    enc.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    np.testing.assert_allclose(enc(traw, t(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile_rows", [128, 256])
def test_blockdiag_pair_equals_jax(graphs, jax_cuts, tile_rows):
    """Tile rows, columns and values of both orientations equal JAX's
    ``_blockdiag_pair``; the compressed rows hold exactly the non-zeros."""
    _, jraw, traw = graphs
    _, _, _, vals = jax_cuts
    stack = np.stack(vals)
    norm = np.asarray(jax.vmap(lambda v: jtam.sym_normalize_vals(v, jraw))(
        jnp.asarray(stack)))
    want, rp, _ = jtam._blockdiag_pair(jraw, norm, tile_rows)
    got = tam.blockdiag_pair(traw, t(norm), tile_rows)
    assert rp == tam._round_up(traw.n_nodes, tile_rows)
    for w, g in ((want.fwd, got.fwd), (want.bwd, got.bwd)):
        np.testing.assert_array_equal(g.tile_rows.numpy(),
                                      np.asarray(w.tile_rows))
        np.testing.assert_array_equal(g.tile_cols.numpy(),
                                      np.asarray(w.tile_cols))
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
        assert (g.n_rows, g.n_cols) == (w.n_rows, w.n_cols)
        assert g.col.numel() == int(np.count_nonzero(np.asarray(w.values)))


def test_blockdiag_product_and_gradient_match_dense(graphs, jax_cuts):
    """The block-diagonal aggregation (K1's plain version on the CPU)
    equals the dense per-member products Â_m h_m, values and gradient
    (Â_mᵀ g_m through the transposed pair)."""
    ds, _, traw = graphs
    _, _, _, vals = jax_cuts
    norm = tam.sym_normalize_vals(t(np.stack(vals)), traw)
    pair = tam.blockdiag_pair(traw, norm, 256)
    agg = tam.blockdiag_aggregate(pair, ds.n_nodes)
    rng = np.random.default_rng(5)
    h = t(rng.normal(size=(CUTS, ds.n_nodes, 7)).astype(np.float32))
    h.requires_grad_(True)
    proj = t(rng.normal(size=(CUTS, ds.n_nodes, 7)).astype(np.float32))
    before = pb.bcsr_spmm.launches
    out = agg(h)
    (out * proj).sum().backward()
    assert pb.bcsr_spmm.launches == before       # the plain version
    e = traw.n_edges
    row, col = traw.row[:e].numpy(), traw.col[:e].numpy()
    for m in range(CUTS):
        dense = np.zeros((ds.n_nodes, ds.n_nodes), np.float64)
        np.add.at(dense, (row, col), norm[m, :e].numpy())
        hm = h[m].detach().numpy().astype(np.float64)
        np.testing.assert_allclose(out[m].detach().numpy(), dense @ hm,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h.grad[m].numpy(),
                                   dense.T @ proj[m].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_interop_maps_stacked_trees():
    """A stacked tree's ``[M, in, out]`` kernels become ``[M, out, in]``
    weights (each member's transpose) and come back unchanged; a 2-D tree
    maps as before."""
    rng = np.random.default_rng(0)
    stacked = {"gcn1": {"fc": {"kernel": rng.normal(size=(4, 5, 6))},
                        "bias": rng.normal(size=(4, 6)),
                        "prelu": {"alpha": rng.normal(size=(4,))}}}
    sd = params_from_flax({"params": stacked})
    assert sd["gcn1.fc.weight"].shape == (4, 6, 5)
    for m in range(4):
        np.testing.assert_array_equal(sd["gcn1.fc.weight"][m].numpy(),
                                      np.float32(stacked["gcn1"]["fc"]
                                                 ["kernel"][m].T))
    assert sd["gcn1.prelu.alpha"].shape == (4,)
    back = params_to_flax(sd)["params"]
    np.testing.assert_array_equal(back["gcn1"]["fc"]["kernel"],
                                  np.float32(stacked["gcn1"]["fc"]["kernel"]))
    flat = {"fc": {"kernel": rng.normal(size=(5, 6))}}
    w = params_from_flax(flat)["fc.weight"]
    np.testing.assert_array_equal(w.numpy(),
                                  np.float32(flat["fc"]["kernel"]).T)
    assert w.is_contiguous()
