"""K2's port and the differentiable tile ops against ``ggad_tpu``.

The port's tile builds (``bcsr_pair_from_graph``, ``bcsr_rect_from_coo``)
must give the JAX package's tile indices and values exactly. The plain
versions of K2 (``bcsr_sddmm_colsum`` square and ``_rect``) are held to
``ggad_tpu.ops.pallas_sddmm`` with its Pallas kernel in interpret mode (as
``tests/test_pallas_spmm.py`` runs it on the CPU): f32 to 1e-5 rel/abs
(true-f32 products on both sides; only the order of the f32 sums differs),
bf16 to 1e-4 (both sides round tiles and operands to bf16 at the same
places and every bf16 product is exact in f32; the longer sums of rounded
operands differ more in order). Gradients of ``bcsr_spmm``, of both K2 ops
and of the K1 VJPs behind them agree with ``jax.grad`` to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ggad_tpu.graph as jg
import ggad_tpu.ops.pallas_sddmm as jps
import ggad_tpu.ops.pallas_spmm as jp
import ggad_tpu.ops.sddmm as jsd
import ggad_tpu_torch.graph as pg
import ggad_tpu_torch.ops.sddmm as psd
from ggad_tpu_torch.ops import bcsr_sddmm as pk2
from ggad_tpu_torch.ops import bcsr_spmm as pb

JAX_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def raw_graphs(n, density, seed, *, empty_cols=False):
    """A + I on both sides; ``empty_cols`` leaves columns 128..255 without
    edges (so the transposed tile set has an empty tile row) and skips +I
    there."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(seed))
    a = sp.lil_matrix(((a + a.T) > 0).astype(np.float32))
    a.setdiag(0)
    a = sp.coo_matrix(a)
    a.eliminate_zeros()
    row, col = a.row, a.col        # no duplicate entries, no self-loops
    loops = np.arange(n)
    row, col = np.concatenate([row, loops]), np.concatenate([col, loops])
    if empty_cols:
        keep = (col < 128) | (col >= 256)
        row, col = row[keep], col[keep]
    val = rng.uniform(0.5, 1.5, row.shape[0]).astype(np.float32)
    return (pg.from_coo(row, col, val, n, device="cpu"),
            jg.from_coo(row, col, val, n))


def assert_tiles_equal(p, j):
    assert (p.n_rows, p.n_cols) == (j.n_rows, j.n_cols)
    np.testing.assert_array_equal(p.tile_rows.numpy(), np.asarray(j.tile_rows))
    np.testing.assert_array_equal(p.tile_cols.numpy(), np.asarray(j.tile_cols))
    np.testing.assert_array_equal(p.values.float().numpy(),
                                  np.asarray(j.values).astype(np.float32))
    ptr = p.tile_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == p.n_tiles
    tr = p.tile_height
    for r in range(p.n_rows // tr):
        assert np.all(p.tile_rows.numpy()[ptr[r]:ptr[r + 1]] == r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tr", [128, 256])
def test_bcsr_pair_from_graph_matches_jax(dtype, tr):
    p_g, j_g = raw_graphs(300, 0.03, 1)
    p = pb.bcsr_pair_from_graph(p_g, dtype, tile_rows=tr)
    j = jp.bcsr_pair_from_graph(j_g, JAX_DTYPE[dtype], tile_rows=tr)
    assert p.n_nodes == j.n_nodes == 300
    assert_tiles_equal(p.fwd, j.fwd)
    assert_tiles_equal(p.bwd, j.bwd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tr,n_tiles_pad", [(128, 0), (256, 0), (128, 12)])
def test_bcsr_rect_from_coo_matches_jax(dtype, tr, n_tiles_pad):
    """Zero values dropped, cover tiles for empty row blocks (rows
    128..255 have no edge), padding tiles repeating the last key."""
    rng = np.random.default_rng(tr + n_tiles_pad)
    n_rows, n_cols = 400, 150
    key = np.unique(rng.integers(0, n_rows * n_cols, 900))
    row, col = key // n_cols, key % n_cols
    keep = (row < 128) | (row >= 256)
    row, col = row[keep], col[keep]
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    val[::7] = 0.0
    p = pb.bcsr_rect_from_coo(row, col, val, n_rows, n_cols, n_tiles_pad,
                              dtype=dtype, tile_rows=tr, device="cpu")
    j = jp.bcsr_rect_from_coo(row, col, val, n_rows, n_cols, n_tiles_pad,
                              dtype=JAX_DTYPE[dtype], tile_rows=tr)
    assert_tiles_equal(p, j)
    assert p.values.dtype == pb.storage_dtype(dtype)
    if n_tiles_pad:
        assert p.n_tiles == n_tiles_pad


def test_bcsr_rect_from_coo_rounds_duplicates_once():
    """Three entries on one element: the port sums them in f32 and rounds
    the sum to bf16 once, as ``bcsr_pair_from_graph`` does; the JAX rect
    build sums in bf16, rounding after each add (``pallas_spmm.py:311-312``),
    here one bf16 ulp lower (ROADMAP Queue 3)."""
    row, col = np.array([0, 0, 0]), np.array([1, 1, 1])
    val = np.array([1.0, 2.0 ** -8, 2.0 ** -8], np.float32)
    p = pb.bcsr_rect_from_coo(row, col, val, 10, 10, dtype="bfloat16",
                              device="cpu")
    j = jp.bcsr_rect_from_coo(row, col, val, 10, 10, dtype=jnp.bfloat16)
    exact = torch.tensor(float(val.sum())).to(torch.bfloat16).item()
    assert p.values[0, 0, 1].item() == exact == 1.0078125
    assert float(np.asarray(j.values)[0, 0, 1]) == 1.0


def emb_pair(n, d, seed):
    e = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(e), jnp.asarray(e)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,tr,empty", [(300, 40, 128, False),
                                          (300, 20, 256, False),
                                          (260, 48, 128, True)])
def test_square_colsum_plain_matches_pallas(dtype, n, d, tr, empty):
    """Square case on the transposed tiles; ragged d; tall tiles; with
    ``empty`` the transposed set has no tile in rows 128..255, whose
    output the port writes as zeros (the Pallas kernel leaves such blocks
    unwritten, so only live rows are compared there)."""
    p_g, j_g = raw_graphs(n, 0.04, n + d, empty_cols=empty)
    pair = pb.bcsr_pair_from_graph(p_g, dtype, tile_rows=tr)
    e_t, e_j = emb_pair(n, d, d)
    pk2.bcsr_sddmm_colsum.launches = 0
    out = pk2.bcsr_sddmm_colsum(pair, e_t).numpy()
    assert pk2.bcsr_sddmm_colsum.launches == 0      # CPU: no kernel
    assert out.shape == (n,) and out.dtype == np.float32
    j_pair = jp.bcsr_pair_from_graph(j_g, JAX_DTYPE[dtype], tile_rows=tr)
    expect = np.asarray(jps.bcsr_sddmm_colsum(j_pair, e_j))
    live = np.r_[0:128, 256:n] if empty else np.arange(n)
    if empty:
        assert pair.bwd.tile_ptr.tolist()[1] == pair.bwd.tile_ptr.tolist()[2]
        assert np.all(out[128:256] == 0.0)
    np.testing.assert_allclose(out[live], expect[live], rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,tr", [(40, 128), (33, 256)])
def test_rect_colsum_plain_matches_pallas(dtype, d, tr):
    """The labeled-column subset's rectangular case, with repeated
    requests (seeds are a subset of the labeled normals)."""
    p_g, j_g = raw_graphs(300, 0.04, d)
    idx = np.concatenate([np.arange(0, 300, 4), np.arange(0, 60, 8)])
    p_sub = psd.tile_affinity_subset(p_g, idx, dtype=dtype, tile_rows=tr)
    j_sub = jsd.tile_affinity_subset(j_g, idx, dtype=dtype, tile_rows=tr)
    assert_tiles_equal(p_sub.pair.fwd, j_sub.pair.fwd)
    assert_tiles_equal(p_sub.pair.bwd, j_sub.pair.bwd)
    e_t, e_j = emb_pair(300, d, 7)
    u = torch.from_numpy(np.unique(idx))
    out = pk2.bcsr_sddmm_colsum_rect(p_sub.pair, e_t[u], e_t).numpy()
    expect = np.asarray(jps.bcsr_sddmm_colsum_rect(
        j_sub.pair, e_j[jnp.asarray(u.numpy())], e_j))
    assert out.shape == (len(u),)
    np.testing.assert_allclose(out, expect, rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_colsum_matches_dense():
    """The plain version against the dense formula rowsum(M ∘ E_r E_cᵀ),
    in f64, to 1e-5."""
    p_g, _ = raw_graphs(200, 0.05, 3)
    tiles = pb.bcsr_pair_from_graph(p_g, tile_rows=128).bwd
    e_r, _ = emb_pair(200, 24, 1)
    e_c, _ = emb_pair(150, 24, 2)
    out = pk2.sddmm_colsum(tiles, e_r, e_c, 200).numpy()
    dense = np.zeros((tiles.n_rows, tiles.n_cols))
    for t, (r, c) in enumerate(zip(tiles.tile_rows.tolist(),
                                   tiles.tile_cols.tolist())):
        dense[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = \
            tiles.values[t].numpy()
    expect = (dense[:200, :150] * (e_r.double().numpy()
                                   @ e_c.double().numpy().T)).sum(1)
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bcsr_spmm_grad_matches_jax(dtype):
    """K1 forward on the tiles, backward on the transposed tiles: the
    gradient of Σ w ⊙ (A h) equals JAX's custom VJP."""
    p_g, j_g = raw_graphs(300, 0.04, 11)
    h_t, h_j = emb_pair(300, 40, 12)
    w = np.random.default_rng(13).normal(size=(300, 40)).astype(np.float32)
    pair = pb.bcsr_pair_from_graph(p_g, dtype, tile_rows=128)
    h_t.requires_grad_()
    pb.bcsr_spmm.launches = 0
    (pb.bcsr_spmm(pair, h_t) * torch.from_numpy(w)).sum().backward()
    assert pb.bcsr_spmm.launches == 0
    j_pair = jp.bcsr_pair_from_graph(j_g, JAX_DTYPE[dtype], tile_rows=128)
    g_j = jax.grad(lambda h: jnp.sum(jp.bcsr_spmm(j_pair, h) * w))(h_j)
    np.testing.assert_allclose(h_t.grad.numpy(), np.asarray(g_j),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_square_colsum_grad_matches_jax(dtype):
    p_g, j_g = raw_graphs(260, 0.04, 21)
    e_t, e_j = emb_pair(260, 24, 22)
    w = np.random.default_rng(23).normal(size=260).astype(np.float32)
    pair = pb.bcsr_pair_from_graph(p_g, dtype, tile_rows=128)
    e_t.requires_grad_()
    (pk2.bcsr_sddmm_colsum(pair, e_t) * torch.from_numpy(w)).sum().backward()
    j_pair = jp.bcsr_pair_from_graph(j_g, JAX_DTYPE[dtype], tile_rows=128)
    g_j = jax.grad(lambda e: jnp.sum(jps.bcsr_sddmm_colsum(j_pair, e) * w))(
        e_j)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(g_j),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_colsum_grad_matches_jax(dtype):
    """Both operands of the rectangular op: d_buf through K1 on the
    ``[U × N]`` set (out rows U ≠ h rows N), d_emb through K1 on the
    ``[N × U]`` set."""
    p_g, j_g = raw_graphs(300, 0.04, 31)
    idx = np.arange(3, 300, 5)
    p_sub = psd.tile_affinity_subset(p_g, idx, dtype=dtype, tile_rows=128)
    j_sub = jsd.tile_affinity_subset(j_g, idx, dtype=dtype, tile_rows=128)
    e_t, e_j = emb_pair(300, 40, 32)
    b_t, b_j = emb_pair(len(idx), 40, 33)
    w = np.random.default_rng(34).normal(size=len(idx)).astype(np.float32)
    e_t.requires_grad_()
    b_t.requires_grad_()
    out = pk2.bcsr_sddmm_colsum_rect(p_sub.pair, b_t, e_t)
    (out * torch.from_numpy(w)).sum().backward()
    g_b, g_e = jax.grad(lambda b, e: jnp.sum(
        jps.bcsr_sddmm_colsum_rect(j_sub.pair, b, e) * w), argnums=(0, 1))(
            b_j, e_j)
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(g_b),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(g_e),
                               rtol=1e-4, atol=1e-4)


def test_rect_matmul_out_rows_differ_from_h_rows():
    """K1 on a rectangular set, as the rect VJP calls it: h has N rows,
    the output U; equal to the dense product in f64 to 1e-5."""
    p_g, _ = raw_graphs(300, 0.04, 41)
    sub = psd.tile_affinity_subset(p_g, np.arange(0, 300, 3), tile_rows=128)
    h, _ = emb_pair(300, 16, 42)
    out = pb.bcsr_matmul(sub.pair.bwd, h, sub.n_uniq).numpy()
    assert out.shape == (sub.n_uniq, 16)
    t = sub.pair.bwd
    dense = np.zeros((t.n_rows, t.n_cols))
    for i, (r, c) in enumerate(zip(t.tile_rows.tolist(),
                                   t.tile_cols.tolist())):
        dense[r * 128:(r + 1) * 128, c * 128:(c + 1) * 128] = \
            t.values[i].numpy()
    expect = dense[:sub.n_uniq, :300] @ h.double().numpy()
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
    p_g, _ = raw_graphs(200, 0.05, 9)
    pair = pb.bcsr_pair_from_graph(p_g, tile_rows=128)
    e = torch.zeros(200, 8)
    with pytest.raises(ValueError):
        pk2.sddmm_colsum(pair.bwd, e, torch.zeros(200, 9))     # d differs
    with pytest.raises(ValueError):
        pk2.sddmm_colsum(pair.bwd, e.double(), e)
    with pytest.raises(ValueError):
        pk2.sddmm_colsum(pair.bwd, torch.zeros(8, 200).t(), e)
    with pytest.raises(ValueError):
        pk2.sddmm_colsum(pair.bwd, e, torch.zeros(pair.bwd.n_cols + 1, 8))
    with pytest.raises(ValueError):
        pk2.sddmm_colsum(pair.bwd, e, e, pair.bwd.n_rows + 1)
    with pytest.raises(ValueError):
        pk2.sddmm_colsum(pair.bwd, e.to("meta"), e.to("meta"))
    with pytest.raises(ValueError):
        pb.bcsr_matmul(pair.fwd, e, 0)
