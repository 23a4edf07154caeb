"""Operation and byte counts on small shapes worked out by hand, and the
counts the drivers take from the benchmark's graph against the
reference's own matrices."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import graphgen, reference, roofline
from portbench.drivers import ggad as ggad_driver
from portbench.tests.portbench_fixtures import (  # noqa: F401
    tiny_configs, tiny_root)


def test_dense_and_sparse_counts():
    assert roofline.dense(2, 3, 4) == 48
    assert roofline.sparse(10, 4) == 80
    # 10 entries × (4-byte column + 4-byte value) + 4 row pointers × 4
    # + H 3×4 f32 + out 3×4 f32
    assert roofline.spmm_bytes(10, 3, 3, 4) == 80 + 16 + 48 + 48


def test_least_time_takes_the_larger_bound():
    # 1e9 entries at d 1000: 2e12 operations (29.85 ms at 67 TFLOP/s)
    # against ≈16 GB (4.8 ms at 3.35 TB/s): operations bound it
    t = roofline.spmm_least_s(10**9, 10**6, 10**6, 1000)
    assert t == pytest.approx(2e12 / 67e12)
    # d 1: 8 GB of entries bound it
    t = roofline.spmm_least_s(10**9, 10**6, 10**6, 1)
    assert t == pytest.approx((8e9 + 4 * (10**6 + 1) + 4e6 + 4e6) / 3.35e12)


def test_ggad_score_flops_by_hand():
    # n 4, f 2, h 8, nnz 10: gcn1 4·2·8·2 = 128, gcn2 4·8·8·2 = 512,
    # Â 10·8·2 = 160, head 4·(8·4 + 4·2 + 2·1)·2 = 336
    assert roofline.ggad_score_flops(n=4, f=2, h=8, nnz=10) == 1136


def test_ggad_train_flops_by_hand():
    # n 4, f 2, h 8, nnz 10, nnz_seed 3, 2 normals, 1 seed, nnz_sub 5
    head = 3 * 2 * (8 * 4 + 4 * 2 + 2 * 1)                   # 252
    fwd = 128 + 512 + 160 + 48 + 128 + head + 80
    bwd = 128 + 2 * 512 + 160 + 48 + 2 * 128 + 2 * head + 2 * 80
    assert roofline.ggad_train_flops(
        n=4, f=2, h=8, nnz=10, nnz_seed=3, n_normal=2, n_seed=1,
        nnz_sub=5) == fwd + bwd


def test_tam_epoch_flops_by_hand():
    # one member: n 4, f 2, h 8, its graph 6 entries, the raw graph 9
    fwd = 2 * 4 * 2 * 16 + 2 * 6 * 16 + 2 * 4 * 16 * 8 + 2 * 6 * 8 \
        + 2 * 9 * 8
    bwd = 2 * 4 * 2 * 16 + 2 * 6 * 16 + 2 * 2 * 4 * 16 * 8 + 2 * 6 * 8 \
        + 2 * 2 * 9 * 8
    assert roofline.tam_epoch_flops(n=4, f=2, h=8, member_nnz=[6],
                                    nnz_raw=9) == fwd + bwd
    assert roofline.tam_epoch_flops(n=4, f=2, h=8, member_nnz=[6, 6],
                                    nnz_raw=9) == 2 * (fwd + bwd)


def test_ggad_work_counts_match_the_reference_matrices(tiny_root):
    cfg = tiny_configs()["ggad-tfinance"]
    cfg["name"] = "ggad-tfinance"
    g = graphgen.load(cfg)
    cell = ggad_driver.Cell.__new__(ggad_driver.Cell)
    cell.graph, cell.cfg, cell.loop = g, cfg, "train"
    ref = reference.GGAD(g, cfg, "cpu")
    w = cell.work()
    assert w["nnz"] == ref.ahat.nnz
    deg = np.diff(g.adj.indptr)
    assert int((deg[g.seed_idx] + 1).sum()) == ref.seed_rows.nnz
    labeled = np.unique(np.concatenate([g.normal_idx, g.seed_idx]))
    assert int((deg[labeled] + 1).sum()) == ref.raw_cols_t.nnz


def test_graph_has_the_configured_shape(tiny_root):
    cfg = tiny_configs()["ggad-tfinance"]
    cfg["name"] = "ggad-tfinance"
    g = graphgen.load(cfg)
    assert g.n_nodes == 600 and g.features.shape == (600, 10)
    assert (g.adj != g.adj.T).nnz == 0 and g.adj.diagonal().sum() == 0
    # the cache gives the same arrays back
    again = graphgen.load(cfg)
    assert (again.adj != g.adj).nnz == 0
    assert np.array_equal(again.seed_idx, g.seed_idx)
