"""The affinity op layer, the seed-row subgraph and the on-device AUROC
against ``ggad_tpu``.

Tolerances: f32 values 1e-5 rel/abs and gradients 1e-4 (true-f32 on both
sides, sums in another order; the gradients pass through more of them);
bf16 tile routes 1e-4 against JAX's bf16 route (same rounding points,
exact products). Index structures (subsets, subgraphs) must be equal.
AUROC 1e-6 (f32 midranks on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ggad_tpu.graph as jg
import ggad_tpu.ops.metrics as jm
import ggad_tpu.ops.pallas_spmm as jp
import ggad_tpu.ops.sddmm as jsd
import ggad_tpu_torch.graph as pg
import ggad_tpu_torch.ops.sddmm as psd
from ggad_tpu_torch.ops import bcsr_spmm as pb
from ggad_tpu_torch.ops.metrics import roc_auc_torch

N, D = 260, 32


@pytest.fixture(scope="module")
def graphs():
    """raw_adj = A + I on both sides, A symmetric with no self-loops."""
    a = sp.random(N, N, density=0.04, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(3))
    a = sp.lil_matrix(((a + a.T) > 0).astype(np.float32))
    a.setdiag(0)
    a = sp.csr_matrix(a)
    a.eliminate_zeros()
    return (pg.add_self_loops(pg.from_scipy(a, device="cpu")),
            jg.add_self_loops(jg.from_scipy(a)))


def emb_pair(seed, n=N, d=D, zero_rows=()):
    e = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    e[list(zero_rows)] = 0.0
    return torch.from_numpy(e), jnp.asarray(e)


def weights(seed, n):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def test_l2_normalize_rows_zero_row_gradient():
    """A zero row stays zero and its gradient is finite (the guard sits
    inside the sqrt), equal to JAX's."""
    e_t, e_j = emb_pair(1, zero_rows=(0, 5))
    w = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)
    e_t.requires_grad_()
    out = psd.l2_normalize_rows(e_t)
    (out * torch.from_numpy(w)).sum().backward()
    assert torch.all(out[[0, 5]] == 0)
    assert torch.isfinite(e_t.grad).all()
    j_out, vjp = jax.vjp(jsd.l2_normalize_rows, e_j)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(vjp(w)[0]),
                               rtol=1e-4, atol=1e-5)


def test_sddmm_dot_and_edge_cosine(graphs):
    p_g, j_g = graphs
    a_t, a_j = emb_pair(3)
    b_t, b_j = emb_pair(4)
    np.testing.assert_allclose(psd.sddmm_dot(p_g, a_t, b_t).numpy(),
                               np.asarray(jsd.sddmm_dot(j_g, a_j, b_j)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(psd.edge_cosine(p_g, a_t).numpy(),
                               np.asarray(jsd.edge_cosine(j_g, a_j)),
                               rtol=1e-5, atol=1e-5)


def test_graph_in_degrees_and_rows_subgraph(graphs):
    p_g, j_g = graphs
    np.testing.assert_allclose(p_g.in_degrees().numpy(),
                               np.asarray(j_g.in_degrees()), rtol=1e-6)
    rows = np.array([17, 3, 200, 3 + 1, 99])
    p_sub, j_sub = pg.rows_subgraph(p_g, rows), jg.rows_subgraph(j_g, rows)
    assert (p_sub.n_nodes, p_sub.n_edges, p_sub.e_pad) == (
        j_sub.n_nodes, j_sub.n_edges, j_sub.row.shape[0])
    for name in ("row", "col", "val", "indptr"):
        np.testing.assert_array_equal(getattr(p_sub, name).numpy(),
                                      np.asarray(getattr(j_sub, name)))
    from ggad_tpu_torch.ops.spmm import spmm
    x_t, _ = emb_pair(5)
    full = spmm(p_g, x_t)[torch.from_numpy(rows)]
    np.testing.assert_allclose(spmm(p_sub, x_t).numpy(), full.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route,tol", [("coo", 1e-5), ("bcsr-f32", 1e-5),
                                       ("bcsr-bf16", 1e-4)])
def test_node_affinity_matches_jax(graphs, route, tol):
    """Values and gradients on the edge path and through K2 (plain
    version) with its two-K1 backward."""
    p_g, j_g = graphs
    if route != "coo":
        dtype = route.split("-")[1]
        dtype = "bfloat16" if dtype == "bf16" else "float32"
        p_g = pb.as_bcsr_graph(p_g, dtype=dtype, tile_rows=128)
        j_g = jp.as_bcsr_graph(
            j_g, dtype=jnp.bfloat16 if dtype == "bfloat16" else np.float32,
            tile_rows=128)
    e_t, e_j = emb_pair(6, zero_rows=(7,))
    w = weights(8, N)
    e_t.requires_grad_()
    aff = psd.node_affinity(p_g, e_t)
    (aff * torch.from_numpy(w)).sum().backward()
    j_aff, vjp = jax.vjp(lambda e: jsd.node_affinity(j_g, e), e_j)
    np.testing.assert_allclose(aff.detach().numpy(), np.asarray(j_aff),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(vjp(w)[0]),
                               rtol=1e-4, atol=1e-4)


def test_affinity_subset_matches_jax(graphs):
    p_g, j_g = graphs
    idx = np.concatenate([np.arange(0, N, 3), np.arange(0, 30, 6)])
    p, j = psd.affinity_subset(p_g, idx), jsd.affinity_subset(j_g, idx)
    assert p.n_uniq == j.n_uniq
    for name in ("row", "col_local", "val", "uniq", "gather", "den"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("variant,tol", [("edge", 1e-5), ("tile-f32", 1e-5),
                                         ("tile-bf16", 1e-4)])
def test_node_affinity_at_matches_jax(graphs, variant, tol):
    """The subset affinity at repeated requests, values and gradients,
    and (f32) equal to the full affinity at those nodes."""
    p_g, j_g = graphs
    idx = np.concatenate([np.arange(0, N, 3), np.arange(0, 30, 6)])
    if variant == "edge":
        p_sub, j_sub = psd.affinity_subset(p_g, idx), jsd.affinity_subset(
            j_g, idx)
    else:
        dtype = "float32" if variant == "tile-f32" else "bfloat16"
        p_sub = psd.tile_affinity_subset(p_g, idx, dtype=dtype)
        j_sub = jsd.tile_affinity_subset(j_g, idx, dtype=dtype)
        np.testing.assert_array_equal(p_sub.inv_den.numpy(),
                                      np.asarray(j_sub.inv_den))
    e_t, e_j = emb_pair(9, zero_rows=(3,))
    w = weights(10, len(idx))
    e_t.requires_grad_()
    at = psd.node_affinity_at(p_sub, e_t)
    (at * torch.from_numpy(w)).sum().backward()
    j_at, vjp = jax.vjp(lambda e: jsd.node_affinity_at(j_sub, e), e_j)
    np.testing.assert_allclose(at.detach().numpy(), np.asarray(j_at),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(vjp(w)[0]),
                               rtol=1e-4, atol=1e-4)
    if variant != "tile-bf16":
        full = psd.node_affinity(p_g, e_t.detach())[torch.from_numpy(idx)]
        np.testing.assert_allclose(at.detach().numpy(), full.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_roc_auc_torch_matches_jax(masked):
    """Ties (rounded scores) and a mask, against ``roc_auc_jnp`` and the
    host ``roc_auc`` on the kept subset."""
    rng = np.random.default_rng(11)
    n = 400
    labels = (rng.random(n) < 0.2).astype(np.float32)
    scores = np.round(rng.normal(size=n) + labels, 1).astype(np.float32)
    mask = (rng.random(n) < 0.6).astype(np.float32) if masked else None
    got = float(roc_auc_torch(
        torch.from_numpy(labels), torch.from_numpy(scores),
        None if mask is None else torch.from_numpy(mask)))
    expect = float(jm.roc_auc_jnp(
        jnp.asarray(labels), jnp.asarray(scores),
        None if mask is None else jnp.asarray(mask)))
    assert got == pytest.approx(expect, abs=1e-6)
    keep = np.ones(n, bool) if mask is None else mask > 0
    assert got == pytest.approx(jm.roc_auc(labels[keep], scores[keep]),
                                abs=1e-6)
