"""K1's port: the BCSR build and the plain version of ``bcsr_spmm`` against
``ggad_tpu``'s BCSR build and its Pallas kernel in interpret mode (as
``tests/test_pallas_spmm.py`` runs it on the CPU).

Tolerances: f32 1e-5 rel/abs (both sides take true-f32 products; only
the order of the f32 sums differs). bf16 2e-5 rel/abs: both sides round the
tiles and H to bf16 at the same places and every bf16 × bf16 product is
exact in f32, so again only the f32 summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ggad_tpu.graph as jg
import ggad_tpu.ops.normalize as jn
import ggad_tpu.ops.pallas_spmm as jp
import ggad_tpu_torch.graph as pg
import ggad_tpu_torch.ops.normalize as pn
from ggad_tpu_torch.ops import bcsr_spmm as pb
from ggad_tpu_torch.ops.spmm import spmm, spmm_coo


def sym_graph(n, density, seed):
    a = sp.random(n, n, density=density, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(seed))
    return sp.csr_matrix(((a + a.T) > 0).astype(np.float32))


def both_adj(n, density, seed):
    a = sym_graph(n, density, seed)
    p_adj, _ = pn.normalize_adj_reference(pg.from_scipy(a, device="cpu"))
    j_adj, _ = jn.normalize_adj_reference(jg.from_scipy(a))
    return p_adj, j_adj


@pytest.mark.parametrize("tr", [128, 256, 1024])
def test_bcsr_from_coo_matches_jax(tr):
    p_adj, j_adj = both_adj(300, 0.04, 1)
    row, col, val = p_adj.host_coo()
    p = pb.bcsr_from_coo(row, col, val, p_adj.n_nodes, tile_rows=tr,
                         device="cpu")
    j = jp.bcsr_from_coo(np.asarray(j_adj.row)[:j_adj.n_edges],
                         np.asarray(j_adj.col)[:j_adj.n_edges],
                         np.asarray(j_adj.val)[:j_adj.n_edges],
                         j_adj.n_nodes, tile_rows=tr)
    assert (p.n_rows, p.n_cols) == (j.n_rows, j.n_cols)
    np.testing.assert_array_equal(p.tile_rows.numpy(), np.asarray(j.tile_rows))
    np.testing.assert_array_equal(p.tile_cols.numpy(), np.asarray(j.tile_cols))
    np.testing.assert_allclose(p.values.numpy(), np.asarray(j.values),
                               rtol=1e-6, atol=1e-7)
    # tile_ptr brackets each tile row's tiles
    ptr = p.tile_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == p.n_tiles
    assert len(ptr) == p.n_rows // tr + 1
    for r in range(len(ptr) - 1):
        assert np.all(p.tile_rows.numpy()[ptr[r]:ptr[r + 1]] == r)


@pytest.mark.parametrize("n,density,seed", [
    (300, 0.04, 0), (400, 0.005, 1), (1200, 0.002, 2), (2100, 0.01, 3)])
def test_pick_tile_rows_matches_jax(n, density, seed):
    a = sym_graph(n, density, seed).tocoo()
    assert pb.pick_tile_rows(a.row, a.col, n) == jp.pick_tile_rows(
        a.row, a.col, n)


def jax_bcsr_spmm(j_adj, h, dtype, tr):
    pair = jp.bcsr_pair_from_graph(j_adj, dtype=dtype, tile_rows=tr)
    return np.asarray(jp.bcsr_spmm(pair, jnp.asarray(h)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-5)])
@pytest.mark.parametrize("n,d,tr", [(300, 40, 128), (200, 16, 256),
                                    (400, 64, 1024)])
def test_plain_bcsr_spmm_matches_pallas(dtype, tol, n, d, tr):
    p_adj, j_adj = both_adj(n, 0.05, n)
    h = np.random.default_rng(n + d).normal(size=(n, d)).astype(np.float32)
    b = pb.as_bcsr_graph(p_adj, dtype=dtype, tile_rows=tr)
    pb.bcsr_spmm.launches = 0
    out = pb.bcsr_spmm(b.tiles, torch.from_numpy(h))
    assert pb.bcsr_spmm.launches == 0        # CPU tensors: no kernel
    assert out.shape == (n, d) and out.dtype == torch.float32
    expect = jax_bcsr_spmm(
        j_adj, h, jnp.bfloat16 if dtype == "bfloat16" else np.float32, tr)
    np.testing.assert_allclose(out.numpy(), expect, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bcsr_spmm_empty_tile_row(dtype):
    """No self-loops and no edge in rows 128..255: tile row 1 has no tiles
    and its output rows must come out as zeros."""
    rng = np.random.default_rng(5)
    n, d = 300, 40
    rows = np.concatenate([rng.integers(0, 128, 900),
                           rng.integers(256, n, 300)])
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.random(rows.shape[0]).astype(np.float32)
    p_g = pg.from_coo(rows, cols, vals, n, device="cpu")
    b = pb.as_bcsr_graph(p_g, dtype=dtype, tile_rows=128)
    assert b.tiles.tile_ptr.tolist()[1] == b.tiles.tile_ptr.tolist()[2]
    h = rng.normal(size=(n, d)).astype(np.float32)
    out = pb.bcsr_spmm(b.tiles, torch.from_numpy(h)).numpy()
    assert np.all(out[128:256] == 0.0)

    hq = h if dtype == "float32" else np.asarray(
        jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32))
    vq = b.tiles.values.float()    # the stored (possibly bf16) values
    dense = np.zeros((b.tiles.n_rows, b.tiles.n_cols), np.float32)
    for t, (r, c) in enumerate(zip(b.tiles.tile_rows.tolist(),
                                   b.tiles.tile_cols.tolist())):
        dense[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = vq[t].numpy()
    expect = dense[:n, :n].astype(np.float64) @ hq.astype(np.float64)
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)

    j_g = jg.from_coo(rows, cols, vals, n)
    j_out = jax_bcsr_spmm(
        j_g, h, jnp.bfloat16 if dtype == "bfloat16" else np.float32, 128)
    live = np.r_[0:128, 256:n]
    np.testing.assert_allclose(out[live], j_out[live], rtol=2e-5, atol=2e-5)


def test_spmm_dispatch_and_coo_path():
    """``spmm`` picks the tiles on a BCSRGraph unless impl='coo'; both
    equal the dense product to 1e-5."""
    p_adj, _ = both_adj(200, 0.05, 9)
    b = pb.as_bcsr_graph(p_adj)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(200, 24)).astype(np.float32))
    dense = sp.coo_matrix((p_adj.host_coo()[2], p_adj.host_coo()[:2]),
                          shape=(200, 200)).toarray()
    expect = dense @ x.numpy()
    for impl in ("auto", "coo"):
        np.testing.assert_allclose(spmm(b, x, impl=impl).numpy(), expect,
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        spmm_coo(p_adj.row, p_adj.col, p_adj.val, x, 200).numpy(), expect,
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        spmm(b, x, impl="xla")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p_adj, _ = both_adj(200, 0.05, 9)
    tiles = pb.as_bcsr_graph(p_adj).tiles
    h = torch.zeros(200, 8)
    with pytest.raises(ValueError):
        pb.bcsr_spmm(tiles, h.double())
    with pytest.raises(ValueError):
        pb.bcsr_spmm(tiles, torch.zeros(8, 200).t())       # not contiguous
    with pytest.raises(ValueError):
        pb.bcsr_spmm(tiles, torch.zeros(tiles.n_cols + 1, 8))
    with pytest.raises(ValueError):
        pb.bcsr_spmm(tiles, h.to("meta"))                  # other device
    with pytest.raises(ValueError):
        pb.bcsr_spmm(pb.BCSR(tiles.tile_rows, tiles.tile_cols,
                             tiles.tile_ptr.long(), tiles.values,
                             tiles.n_rows, tiles.n_cols), h)
    with pytest.raises(NotImplementedError):
        pb.bcsr_spmm(tiles, h.requires_grad_())
    with pytest.raises(ValueError):
        pb.bcsr_from_coo(np.zeros(1), np.zeros(1), np.ones(1), 4,
                         tile_rows=100, device="cpu")
