"""The halo path's host-side build functions against
``ggad_tpu.parallel.spmm_shard`` and ``ggad_tpu.datasets.partition``,
element for element.

Both packages partition the same graph (built from one scipy matrix, so
the edge values agree bit for bit): ``partition_edges``,
``build_halo_plan`` (dense, ring, sched at D 2, 4, 8), ``build_halo_bcsr``
(f32 exact, bf16 equal), ``build_halo_ell``,
``build_halo_affinity_subset`` (with and without tiles) and
``build_halo_seed_rows`` give equal arrays. JAX stacks the per-shard tile
sets and tables on a device axis, padding each shard to the largest
count; the port keeps each shard's own set, so each shard's set is held
against JAX's prefix and JAX's tail is checked to be padding. The
partitioners give equal labels for equal seeds.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from ggad_tpu.datasets import partition as jpart
from ggad_tpu.graph import add_self_loops as j_add_self_loops
from ggad_tpu.graph import from_scipy as j_from_scipy
from ggad_tpu.parallel import spmm_shard as js
from ggad_tpu_torch.datasets import partition as tpart
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import add_self_loops, from_scipy
from ggad_tpu_torch.parallel import spmm_shard as ts

SCHEDULES = ("dense", "ring", "sched")


def weighted_graph(n=260, density=0.05, seed=0):
    """Random symmetric pattern with float32 weights off the bf16 grid,
    so the bf16 tile stores round."""
    mat = sp.random(n, n, density=density, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(seed))
    return sp.csr_matrix(mat + mat.T)


def skewed_graph(n=512, d=8, wide=((1, 0), (4, 2), (3, 5)), w=60, bg=4,
                 seed=0):
    """``tests/test_parallel.py``'s block graph whose wide boundaries sit
    on pairs at different ring distances: matched rounds beat the ring."""
    r = n // d
    rng = np.random.RandomState(seed)
    rows, cols = [], []
    for dst, src in wide:
        rows.extend(rng.randint(0, r, w) + dst * r)
        cols.extend(rng.choice(r, w, replace=False) + src * r)
    for dst in range(d):
        for src in range(d):
            if dst == src or (dst, src) in wide:
                continue
            rows.extend(rng.randint(0, r, bg) + dst * r)
            cols.extend(rng.choice(r, bg, replace=False) + src * r)
    rows.extend(range(n))
    cols.extend(range(n))
    mat = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(n, n)).tocsr()
    mat.data[:] = 1.0
    return mat


def graphs(mat, self_loops=True):
    jg, tg = j_from_scipy(mat), from_scipy(mat, device="cpu")
    if self_loops:
        return j_add_self_loops(jg), add_self_loops(tg)
    return jg, tg


def shards(a, D):
    """A JAX ``[D·X, ...]`` array as ``[D, X, ...]``."""
    a = np.asarray(a)
    return a.reshape((D, -1) + a.shape[1:])


def f32(a):
    return np.asarray(a).astype(np.float32)


def assert_part_equal(j, t):
    D = j.n_shards
    for name in ("row_local", "col", "val"):
        np.testing.assert_array_equal(shards(getattr(j, name), D),
                                      getattr(t, name).numpy(), name)
    for name in ("n_shards", "rows_per_shard", "e_shard", "n_nodes",
                 "edge_chunks"):
        assert getattr(t, name) == getattr(j, name), name


def assert_plan_equal(j, t):
    D = j.n_shards
    np.testing.assert_array_equal(np.asarray(j.send_idx), t.send_idx.numpy())
    np.testing.assert_array_equal(shards(j.col_remap, D),
                                  t.col_remap.numpy())
    np.testing.assert_array_equal(shards(j.den, D), t.den.numpy())
    assert (t.boundary, t.rows_per_shard, t.dist_widths, t.dist_perms) == \
        (j.boundary, j.rows_per_shard, j.dist_widths, j.dist_perms)
    assert t.buf_width == j.buf_width


def assert_tiles_equal(j_rows, j_cols, j_vals, t_sets, D):
    """Shard d's tile set equals JAX's stacked prefix; the rest of JAX's
    stack repeats the last key with zero tiles."""
    rows, cols = shards(j_rows, D), shards(j_cols, D)
    vals = f32(j_vals).reshape((D, -1) + np.asarray(j_vals).shape[1:])
    for d, b in enumerate(t_sets):
        t = b.n_tiles
        np.testing.assert_array_equal(rows[d, :t], b.tile_rows.numpy())
        np.testing.assert_array_equal(cols[d, :t], b.tile_cols.numpy())
        np.testing.assert_array_equal(vals[d, :t], b.values.float().numpy())
        assert np.all(rows[d, t:] == rows[d, t - 1])
        assert np.all(cols[d, t:] == cols[d, t - 1])
        assert not vals[d, t:].any()


@pytest.mark.parametrize("edge_chunks", [None, 3])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_partition_edges_matches_jax(D, edge_chunks):
    jg, tg = graphs(weighted_graph())
    j = js.partition_edges(jg, D, edge_chunks=edge_chunks)
    t = ts.partition_edges(tg, D, edge_chunks=edge_chunks)
    assert_part_equal(j, t)
    x = np.arange(260 * 3, dtype=np.float32).reshape(260, 3)
    np.testing.assert_array_equal(
        shards(js.pad_nodes(x, j), D), ts.pad_nodes(x, t).numpy())


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_build_halo_plan_matches_jax(D, schedule):
    jg, tg = graphs(weighted_graph(seed=D))
    j = js.build_halo_plan(js.partition_edges(jg, D), schedule)
    t = ts.build_halo_plan(ts.partition_edges(tg, D), schedule)
    assert_plan_equal(j, t)
    assert ts.halo_comm_stats(t, 300) == js.halo_comm_stats(j, 300)


def test_sched_plan_on_a_skewed_graph_matches_jax():
    """The skewed graph is where matched rounds beat the ring: the port
    keeps the same rounds."""
    jg, tg = graphs(skewed_graph(), self_loops=False)
    j = js.build_halo_plan(js.partition_edges(jg, 8), "sched")
    t = ts.build_halo_plan(ts.partition_edges(tg, 8), "sched")
    assert t.dist_perms        # the matched rounds won
    assert_plan_equal(j, t)
    ring = ts.build_halo_plan(ts.partition_edges(tg, 8), "ring")
    assert t.buf_width < ring.buf_width


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,schedule", [(2, "dense"), (4, "ring"),
                                        (4, "sched")])
def test_build_halo_bcsr_matches_jax(D, schedule, dtype):
    jg, tg = graphs(weighted_graph(seed=1))
    jp, tp = js.partition_edges(jg, D), ts.partition_edges(tg, D)
    j = js.build_halo_bcsr(jp, js.build_halo_plan(jp, schedule),
                           dtype=dtype)
    t = ts.build_halo_bcsr(tp, ts.build_halo_plan(tp, schedule),
                           dtype=dtype)
    for name in ("r_row_pad", "r_col_pad", "w_row_pad", "w_col_pad"):
        assert getattr(t, name) == getattr(j, name), name
    for j_pre, t_sets in (("loc", t.loc), ("locT", t.locT),
                          ("fwd", t.fwd), ("bwd", t.bwd)):
        assert_tiles_equal(getattr(j, f"{j_pre}_rows"),
                           getattr(j, f"{j_pre}_cols"),
                           getattr(j, f"{j_pre}_vals"), t_sets, D)
        assert all(b.values.dtype == ts.storage_dtype(dtype) for b in t_sets)


def test_build_halo_bcsr_budget_matches_jax(capsys):
    """Both decline the tile store past the budget (and say so), and
    build it under the default one."""
    jg, tg = graphs(weighted_graph())
    jp, tp = js.partition_edges(jg, 2), ts.partition_edges(tg, 2)
    jplan, tplan = js.build_halo_plan(jp), ts.build_halo_plan(tp)
    assert js.build_halo_bcsr(jp, jplan, mem_budget_bytes=1) is None
    assert ts.build_halo_bcsr(tp, tplan, mem_budget_bytes=1) is None
    assert "ELL route" in capsys.readouterr().err
    assert ts.build_halo_bcsr(tp, tplan) is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,schedule", [(2, "dense"), (4, "ring")])
def test_build_halo_ell_matches_jax(D, schedule, dtype):
    jg, tg = graphs(weighted_graph(seed=2))
    jp, tp = js.partition_edges(jg, D), ts.partition_edges(tg, D)
    j = js.build_halo_ell(jp, js.build_halo_plan(jp, schedule), dtype=dtype)
    t = ts.build_halo_ell(tp, ts.build_halo_plan(tp, schedule), dtype=dtype)
    assert (t.r_rows, t.b_rows) == (j.r_rows, j.b_rows)
    for side in ("fwd", "bwd"):
        idx, val = np.asarray(getattr(j, f"{side}_idx")), f32(
            getattr(j, f"{side}_val"))
        ov = [np.asarray(getattr(j, f"{side}_ov_{k}"))
              for k in ("row", "col", "val")]
        for d, e in enumerate(getattr(t, side)):
            np.testing.assert_array_equal(idx[d], e.idx.numpy())
            np.testing.assert_array_equal(val[d], e.val.float().numpy())
            m = e.n_overflow
            for a, b in zip(ov, (e.ov_row, e.ov_col, e.ov_val)):
                np.testing.assert_array_equal(a[d, :m], b.numpy())
            if m:
                assert np.all(ov[0][d, m:] == ov[0][d, m - 1])
            assert not ov[2][d, m:].any()


@pytest.mark.parametrize("tiles_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("D", [2, 4])
def test_build_halo_affinity_subset_matches_jax(D, tiles_dtype):
    jg, tg = graphs(weighted_graph(seed=3))
    rng = np.random.default_rng(D)
    idx = np.concatenate([rng.choice(260, 60, replace=False),
                          rng.choice(260, 20, replace=False)])
    j = js.build_halo_affinity_subset(js.partition_edges(jg, D), idx,
                                      tiles_dtype=tiles_dtype)
    t = ts.build_halo_affinity_subset(ts.partition_edges(tg, D), idx,
                                      tiles_dtype=tiles_dtype)
    for name in ("row_local", "col_sub", "val"):
        np.testing.assert_array_equal(shards(getattr(j, name), D),
                                      getattr(t, name).numpy(), name)
    for name in ("uniq", "gather", "den"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), name)
    assert (t.n_uniq, t.e_sub) == (j.n_uniq, j.e_sub)
    if tiles_dtype is None:
        assert t.t_fwd is None and j.t_fwd_rows is None
        return
    assert_tiles_equal(j.t_fwd_rows, j.t_fwd_cols, j.t_fwd_vals, t.t_fwd, D)
    assert_tiles_equal(j.t_bwd_rows, j.t_bwd_cols, j.t_bwd_vals, t.t_bwd, D)
    assert (t.t_fwd[0].n_rows, t.t_fwd[0].n_cols, t.t_bwd[0].n_rows,
            t.t_bwd[0].n_cols) == (j.f_row_pad, j.f_col_pad, j.b_row_pad,
                                   j.b_col_pad)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_build_halo_seed_rows_matches_jax(D):
    jg, tg = graphs(weighted_graph(seed=4))
    seeds = np.random.default_rng(D).choice(260, 25, replace=False)
    j = js.build_halo_seed_rows(js.partition_edges(jg, D), seeds)
    t = ts.build_halo_seed_rows(ts.partition_edges(tg, D), seeds)
    for name in ("seed_pos", "col_local", "val"):
        np.testing.assert_array_equal(shards(getattr(j, name), D),
                                      getattr(t, name).numpy(), name)
    assert (t.n_seed, t.e_seed) == (j.n_seed, j.e_seed)


@pytest.mark.parametrize("fn", ["lp_partition", "multilevel_partition"])
@pytest.mark.parametrize("D", [2, 4])
def test_partitioners_give_jax_labels(fn, D):
    """Equal seeds, equal labels: the refinement and the matching are the
    native helpers' loops (their generator, their float32 sums);
    600 nodes make the multilevel path coarsen once."""
    adj = synthetic_gad(n_nodes=600, avg_degree=8, feat_dim=4,
                        n_communities=5, seed=D).adj
    block = -(-600 // D)
    for seed in (0, 3):
        j = getattr(jpart, fn)(adj, D, seed=seed, exact_block=block)
        t = getattr(tpart, fn)(adj, D, seed=seed, exact_block=block)
        np.testing.assert_array_equal(t, j)
        assert np.bincount(t).tolist() == [block] * (D - 1) + [
            600 - block * (D - 1)]
        assert tpart.cut_fraction(adj, t) == jpart.cut_fraction(adj, j)
        np.testing.assert_array_equal(tpart.partition_order(t),
                                      jpart.partition_order(j))


def test_native_helpers_match_jax_on_weights():
    """The weighted refinement and matching (the multilevel path's) on a
    float-weighted graph with unit and integer node weights."""
    from ggad_tpu import native

    a = weighted_graph(n=300, seed=6)
    part0 = np.random.default_rng(0).integers(0, 4, 300).astype(np.int32)
    node_w = np.random.default_rng(1).integers(1, 4, 300).astype(np.int32)
    for nw in (None, node_w):
        j = native.partition_refine(a.indptr, a.indices, part0, 4, 120,
                                    rounds=5, seed=9, weights=a.data,
                                    node_w=nw)
        t = tpart.partition_refine(a.indptr, a.indices, part0, 4, 120,
                                   rounds=5, seed=9, weights=a.data,
                                   node_w=nw)
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tpart.hem_match(a.indptr, a.indices, a.data, seed=5),
        native.hem_match(a.indptr, a.indices, a.data, seed=5))


def test_reorder_lp_matches_jax():
    from ggad_tpu.datasets.synthetic import synthetic_gad as j_synthetic

    kw = dict(n_nodes=400, avg_degree=8, feat_dim=4, n_communities=4,
              seed=1)
    j = jpart.reorder_lp(j_synthetic(**kw), 4, multilevel=False)
    t = tpart.reorder_lp(synthetic_gad(**kw), 4, multilevel=False)
    assert (t.adj != j.adj).nnz == 0
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.ano_labels, j.ano_labels)
    np.testing.assert_array_equal(t.normal_label_idx, j.normal_label_idx)
