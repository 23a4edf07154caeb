"""The ELL tables and products of ``ggad_tpu_torch.ops.ell_spmm`` against
``ggad_tpu.ops.ell_spmm``, RCM reordering, and the ELL route of the
trainer.

Tolerances: table builds (indices, values, permutations, residuals, value
maps) equal JAX's arrays exactly; f32 products 1e-5 rel/abs and their
gradients 1e-4 (sums over the slots in another order); bf16 tables 1e-3
(the same rounding points, sums in another order); the affinity column
sums 1e-5 and their gradients 2e-4 rel / 2e-5 abs, as
``tests/test_ell_spmm.py`` holds them against the edge path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggad_tpu.graph as jg
import ggad_tpu.ops.ell_spmm as je
import ggad_tpu.ops.sddmm as jsd
import ggad_tpu_torch.graph as pg
import ggad_tpu_torch.ops.ell_spmm as pe
import ggad_tpu_torch.ops.sddmm as psd
from ggad_tpu.ops.spmm import spmm as j_spmm
from ggad_tpu_torch.ops.spmm import spmm as p_spmm

N, D = 280, 20


def random_coo(n_rows=N, n_cols=N, seed=0, max_deg=23):
    """Rows of degree 0..max_deg (some empty), one hub row of degree 100
    that spills past the cap of 64, duplicate edges, shuffled edge
    order."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, max_deg + 1, n_rows)
    deg[rng.choice(n_rows, 6, replace=False)] = 0
    deg[1] = 100
    row = np.repeat(np.arange(n_rows), deg)
    col = rng.integers(0, n_cols, row.shape[0])
    val = rng.random(row.shape[0]).astype(np.float32) + 0.1
    order = rng.permutation(row.shape[0])
    return row[order], col[order], val[order]


def graphs(seed=0, self_loops=False, max_deg=23):
    row, col, val = random_coo(seed=seed, max_deg=max_deg)
    p, j = (pg.from_coo(row, col, val, N, device="cpu"),
            jg.from_coo(row, col, val, N))
    if self_loops:
        p, j = pg.add_self_loops(p), jg.add_self_loops(j)
    return p, j


@pytest.fixture
def min_rows(request, monkeypatch):
    """The bucket floor on both sides: JAX's 256 (at this size every
    small bucket merges down and the residual is large) or, by default, 8
    (every ladder step kept). The products share one graph per fixture
    below, so JAX's compiled ops are reused across tests."""
    value = getattr(request, "param", 8)
    monkeypatch.setattr(je, "_SIGMA_MIN_ROWS", value)
    monkeypatch.setattr(pe, "_SIGMA_MIN_ROWS", value)
    return value


BOTH_FLOORS = pytest.mark.parametrize("min_rows", [256, 8], indirect=True,
                                      ids=["min_rows_256", "min_rows_8"])


# the products' graphs: degrees up to 12 (buckets K 2 to 16 plus the hub's
# residual) keep the JAX side's unrolled sweeps, and so its compiles, short
@pytest.fixture(scope="module")
def plain():
    return graphs(seed=5, max_deg=12)


@pytest.fixture(scope="module")
def looped():
    return graphs(seed=5, self_loops=True, max_deg=12)


def arr(x):
    """A torch or JAX array as numpy, bf16 widened to f32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        str(x.dtype) == "bfloat16" else x


def assert_same(p, j, fields):
    for f in fields:
        a, b = arr(getattr(p, f)), arr(getattr(j, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_sigma_equal(p: pe.ELLSigma, j):
    assert (p.n_rows, p.n_zero) == (j.n_rows, j.n_zero)
    assert len(p.buckets) == len(j.buckets)
    for pb_, jb in zip(p.buckets, j.buckets):
        assert_same(pb_, jb, ("idx", "val"))
        assert str(pb_.val.dtype).endswith(str(jb.val.dtype).split(".")[-1])
    assert_same(p, j, ("perm", "inv", "ov_row", "ov_col", "ov_val"))


def assert_flat_equal(p: pe.ELL, j):
    assert p.n_rows == j.n_rows and p.k == j.k
    assert_same(p, j, ("idx", "val", "ov_row", "ov_col", "ov_val"))


# ---------------------------------------------------------------------------
# Table builds: equal to JAX's arrays
# ---------------------------------------------------------------------------

@BOTH_FLOORS
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigma_tables_equal_jax(min_rows, dtype):
    """Square tables both ways: buckets, perm/inv, the zero block and the
    512-padded residual (the hub, and the tails of merged buckets)."""
    row, col, val = random_coo()
    p = pe.ell_sigma_from_coo(row, col, val, N, dtype=dtype, device="cpu")
    j = je.ell_sigma_from_coo(row, col, val, N, dtype=dtype)
    assert_sigma_equal(p, j)
    assert p.n_zero == 6 and p.n_overflow % 512 == 0 and p.n_overflow
    pt = pe.ell_sigma_from_coo(col, row, val, N, dtype=dtype, device="cpu")
    assert_sigma_equal(pt, je.ell_sigma_from_coo(col, row, val, N,
                                                 dtype=dtype))
    if min_rows == 8:
        assert [b.idx.shape[0] for b in p.buckets] == [2, 4, 8, 16, 32]


@BOTH_FLOORS
def test_sigma_rect_tables_equal_jax(min_rows):
    """``[N × U]`` and ``[U × N]`` tables, U = 37 columns."""
    u = 37
    row, col, val = random_coo(n_cols=u, seed=4)
    assert_sigma_equal(pe.ell_sigma_from_coo(row, col, val, N, device="cpu"),
                       je.ell_sigma_from_coo(row, col, val, N))
    assert_sigma_equal(pe.ell_sigma_from_coo(col, row, val, u, device="cpu"),
                       je.ell_sigma_from_coo(col, row, val, u))


@pytest.mark.parametrize("kw", [{}, {"k": 6}, {"coverage": 0.5, "k_max": 8},
                                {"dtype": "bfloat16"}],
                         ids=["picked", "k6", "coverage", "bf16"])
def test_flat_tables_equal_jax(kw):
    row, col, val = random_coo(seed=1)
    assert_flat_equal(pe.ell_from_coo(row, col, val, N, device="cpu", **kw),
                      je.ell_from_coo(row, col, val, N, **kw))
    assert_flat_equal(pe.ell_from_coo(col, row, val, N, device="cpu", **kw),
                      je.ell_from_coo(col, row, val, N, **kw))


def test_pick_k_equals_jax():
    rng = np.random.default_rng(5)
    cases = [np.zeros(10, np.int64), rng.integers(0, 9, 500),
             rng.zipf(1.7, 800).clip(0, 400), np.full(50, 70)]
    for deg in cases:
        for cov, k_max in ((0.98, 64), (0.5, 16), (1.0, 8)):
            assert pe._pick_k(deg, cov, k_max) == je._pick_k(deg, cov, k_max)


@pytest.mark.parametrize("transpose", [False, True])
def test_value_maps_equal_jax(transpose):
    """The edge → slot maps, and the planes they rebuild from new values."""
    g, gj = graphs(seed=2)
    row, col, _ = g.host_coo()
    k = pe.ell_from_coo(col if transpose else row, row if transpose else col,
                        np.ones(len(row)), N, device="cpu").k
    p = pe.ell_value_maps(row, col, N, k, transpose=transpose, device="cpu")
    j = je.ell_value_maps(row, col, N, k, transpose=transpose)
    assert_same(p, j, ("slot_map", "slot_mask", "ov_map", "ov_mask"))
    v = np.zeros(g.e_pad, np.float32)
    v[:g.n_edges] = np.random.default_rng(3).normal(size=g.n_edges)
    for a, b in zip(pe.ell_remap_values(p, torch.from_numpy(v)),
                    je.ell_remap_values(j, jnp.asarray(v))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@BOTH_FLOORS
def test_affinity_subset_tables_equal_jax(min_rows):
    g, gj = graphs(seed=3, self_loops=True)
    idx = np.random.default_rng(6).integers(0, N, 60)
    idx = np.concatenate([idx, idx[:7]])            # repeated ids
    p = pe.ell_affinity_subset(g, idx)
    j = je.ell_affinity_subset(gj, idx)
    assert p.n_uniq == j.n_uniq
    assert_sigma_equal(p.fwd, j.fwd)
    assert_sigma_equal(p.bwd, j.bwd)
    assert_same(p, j, ("uniq", "gather", "inv_den", "umask", "upos"))


# ---------------------------------------------------------------------------
# Products, values and gradients against JAX's
# ---------------------------------------------------------------------------

def x_pair(seed, n=N, d=D):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def port_ref(f, x, cot):
    """``f(x)`` and the gradient of ``Σ f(x) · cot`` on the port."""
    x = x.clone().requires_grad_()
    out = f(x)
    (out * cot).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def jax_ref(f, a, cot, dtype="float32"):
    """``f(a)`` and its VJP of ``cot`` on the JAX side: compiled in f32
    (one compile instead of one per op); eager in bf16, since XLA's
    compiled CPU code keeps each bf16 product in f32 (ROADMAP Queue 3)."""
    def both(a):
        out, vjp = jax.vjp(f, a)
        return out, vjp(cot)[0]

    out, grad = both(a) if dtype == "bfloat16" else jax.jit(both)(a)
    return np.asarray(out), np.asarray(grad)


def assert_ref(port, ref, tol_value, tol_grad):
    for got, exp, (rtol, atol) in zip(port, ref, (tol_value, tol_grad)):
        np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol)


F32 = (1e-5, 1e-5), (1e-4, 1e-4)            # products: values, gradients
AFFINITY = (1e-5, 1e-5), (2e-4, 2e-5)       # column sums
BF16 = (1e-3, 1e-3), (1e-3, 1e-3)


@pytest.mark.parametrize("min_rows,layout,dtype", [
    (256, "sigma", "float32"), (8, "sigma", "float32"),
    (8, "sigma", "bfloat16"), (8, "flat", "float32"),
    (8, "flat", "bfloat16")], indirect=["min_rows"])
def test_ell_spmm_value_and_grad_match_jax(plain, min_rows, layout, dtype):
    g, gj = plain
    # the picked flat K is above 16 here, where JAX sweeps in a lax.scan,
    # whose compiled bf16 product XLA's CPU backend keeps in f32 (ROADMAP
    # Queue 3), so the bf16 case holds the unrolled sweeps at K = 16
    kw = {"k": 16} if (layout, dtype) == ("flat", "bfloat16") else {}
    pair = pe.as_ell_graph(g, layout=layout, dtype=dtype, **kw).tables
    pair_j = je.as_ell_graph(gj, layout=layout, dtype=dtype, **kw).tables
    x, xj = x_pair(7)
    w, wj = x_pair(8)
    assert_ref(port_ref(lambda a: pe.ell_spmm(pair, a), x, w),
               jax_ref(lambda a: je.ell_spmm(pair_j, a), xj, wj, dtype),
               *(BF16 if dtype == "bfloat16" else F32))


def test_seed_rect_tables_spmm_match_jax(plain, min_rows):
    """A row subgraph's ``[S × N]`` / ``[N × S]`` sigma pair, the trainer's
    seed aggregation: product and gradient."""
    g, gj = plain
    seeds = np.random.default_rng(1).choice(N, 30, replace=False)
    sr, sc, sv = pg.rows_subgraph(g, seeds).host_coo()

    def pair(lib, **kw):
        return lib.ELLPair(
            fwd=lib.ell_sigma_from_coo(sr, sc, sv, 30, **kw),
            bwd=lib.ell_sigma_from_coo(sc, sr, sv, N, **kw), n_nodes=30)

    x, xj = x_pair(2)
    w, wj = x_pair(3, n=30)
    pair_p, pair_j = pair(pe, device="cpu"), pair(je)
    port = port_ref(lambda a: pe.ell_spmm(pair_p, a), x, w)
    assert port[0].shape == (30, D)
    assert_ref(port, jax_ref(lambda a: je.ell_spmm(pair_j, a), xj, wj), *F32)


@pytest.mark.parametrize("layout", ["sigma", "flat"])
def test_affinity_colsum_value_and_grad_match_jax(looped, min_rows, layout):
    g, gj = looped
    pair = pe.as_ell_graph(g, layout=layout).tables
    pair_j = je.as_ell_graph(gj, layout=layout).tables
    e, ej = x_pair(11)
    w = np.random.default_rng(12).normal(size=N).astype(np.float32)
    assert_ref(
        port_ref(lambda a: pe.ell_affinity_colsum(
            pair, psd.l2_normalize_rows(a)), e, torch.from_numpy(w)),
        jax_ref(lambda a: je.ell_affinity_colsum(
            pair_j, jsd.l2_normalize_rows(a)), ej, jnp.asarray(w)),
        *AFFINITY)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_subset_affinity_value_and_grad_match_jax(looped, min_rows, dtype):
    """``node_affinity_at`` on the rectangular ELL subset, at repeated
    ids, against JAX's, and (f32) against the full affinity."""
    g, gj = looped
    idx = np.random.default_rng(13).integers(0, N, 50)
    idx = np.concatenate([idx, idx[:5]])
    sub = pe.ell_affinity_subset(g, idx, dtype=dtype)
    sub_j = je.ell_affinity_subset(gj, idx, dtype=dtype)
    e, ej = x_pair(14)
    w = np.random.default_rng(15).normal(size=len(idx)).astype(np.float32)
    port = port_ref(lambda a: psd.node_affinity_at(sub, a), e,
                    torch.from_numpy(w))
    assert_ref(port, jax_ref(lambda a: jsd.node_affinity_at(sub_j, a), ej,
                             jnp.asarray(w), dtype),
               *(BF16 if dtype == "bfloat16" else AFFINITY))
    if dtype == "float32":
        full = psd.node_affinity(g, e)[torch.from_numpy(idx)]
        np.testing.assert_allclose(port[0], full.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_dispatch_on_an_ell_graph_matches_jax(looped, min_rows):
    """``ops.spmm`` and ``node_affinity`` dispatch an ELLGraph to its
    tables; ``impl='coo'`` takes the delegated COO arrays."""
    g, gj = looped
    eg = pe.as_ell_graph(g, layout="sigma")
    eg_j = je.as_ell_graph(gj, layout="sigma")
    x, xj = x_pair(16)
    w, wj = x_pair(17)
    assert_ref(port_ref(lambda a: p_spmm(eg, a), x, w),
               jax_ref(lambda a: j_spmm(eg_j, a), xj, wj), *F32)
    torch.testing.assert_close(p_spmm(eg, x, impl="coo"),
                               p_spmm(g, x), rtol=0, atol=0)
    v = np.random.default_rng(18).normal(size=N).astype(np.float32)
    assert_ref(port_ref(lambda a: psd.node_affinity(eg, a), x,
                        torch.from_numpy(v)),
               jax_ref(lambda a: jsd.node_affinity(eg_j, a), xj,
                       jnp.asarray(v)), *AFFINITY)


# ---------------------------------------------------------------------------
# Chunked gathers, forward-only pairs, the graph wrapper
# ---------------------------------------------------------------------------

def test_overflow_spmm_chunked_matches_unchunked(monkeypatch):
    """The residual in chunks (a tiny element cap) equals one gather, and
    equals JAX's chunked residual."""
    r = np.random.default_rng(11)
    e, n, d = 1000, 64, 7
    row = np.sort(r.integers(0, n, e)).astype(np.int32)
    col = r.integers(0, n, e).astype(np.int32)
    val = r.standard_normal(e).astype(np.float32)
    x = r.standard_normal((n, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (row, col, val, x)]
    full = pe._overflow_spmm(*args, n)
    monkeypatch.setattr(pe, "_OV_CHUNK_ELEMS", 256)
    monkeypatch.setattr(je, "_OV_CHUNK_ELEMS", 256)
    chunked = pe._overflow_spmm(*args, n)
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=1e-6)
    jax_chunked = je._overflow_spmm(*(jnp.asarray(a) for a in
                                      (row, col, val, x)), n)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jax_chunked),
                               rtol=1e-5, atol=1e-5)


def test_chunked_slot_gathers_match_unchunked(monkeypatch):
    """Bucket gathers and residual column sums split into row chunks give
    the same products, column sums and gradients."""
    g, _ = graphs(seed=17, self_loops=True)
    eg = pe.as_ell_graph(g, layout="sigma")
    sub = pe.ell_affinity_subset(g, np.arange(0, N, 3))

    def run():
        x = x_pair(18)[0].requires_grad_()
        e = psd.l2_normalize_rows(x)
        outs = (pe.ell_spmm(eg.tables, x), pe.ell_affinity_colsum(
            eg.tables, e), pe.ell_subset_colsum(sub, e))
        sum(o.sin().sum() for o in outs).backward()
        return [o.detach() for o in outs] + [x.grad]

    whole = run()
    monkeypatch.setattr(pe, "_OV_CHUNK_ELEMS", 3 * D)
    for a, b in zip(run(), whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_forward_only_graph_and_with_transpose():
    """Serving builds the forward table only; it takes no gradient until
    ``with_transpose`` adds a table equal to a full build's."""
    g, _ = graphs(seed=19)
    fwd_only = pe.as_ell_graph(g, layout="sigma", dtype="bfloat16",
                               transpose=False)
    assert fwd_only.tables.bwd is None
    x = x_pair(20)[0].requires_grad_()
    with pytest.raises(ValueError, match="transpose"):
        pe.ell_spmm(fwd_only.tables, x)
    with torch.no_grad():
        pe.ell_spmm(fwd_only.tables, x)
    full = fwd_only.with_transpose()
    assert full.with_transpose() is full
    expect = pe.as_ell_graph(g, layout="sigma", dtype="bfloat16")
    assert_sigma_equal(full.tables.bwd, expect.tables.bwd)
    flat = pe.as_ell_graph(g, k=6, transpose=False).with_transpose()
    assert flat.tables.bwd.k == 6
    for name in ("row", "col", "val", "indptr"):
        assert getattr(full, name) is getattr(g, name)
    assert (full.n_nodes, full.n_edges, full.device) == \
        (g.n_nodes, g.n_edges, g.device)
    torch.testing.assert_close(full.in_degrees(), g.in_degrees())
    torch.testing.assert_close(full.out_degrees(), g.out_degrees())
    with pytest.raises(ValueError, match="layout"):
        pe.as_ell_graph(g, layout="csr")


# ---------------------------------------------------------------------------
# Host helpers and the trainer's route
# ---------------------------------------------------------------------------

def test_reorder_rcm_equals_jax():
    from ggad_tpu.datasets.reorder import reorder_rcm as j_reorder
    from ggad_tpu.datasets.reorder import tile_occupancy as j_occupancy
    from ggad_tpu.datasets.synthetic import synthetic_gad as j_synthetic
    from ggad_tpu_torch.datasets.reorder import (
        rcm_permutation,
        reorder_rcm,
        tile_occupancy,
    )
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad

    kw = dict(n_nodes=300, avg_degree=6, feat_dim=8, n_communities=6,
              seed=9)
    ds, ds_j = synthetic_gad(**kw), j_synthetic(**kw)
    from ggad_tpu.datasets.reorder import rcm_permutation as j_perm
    np.testing.assert_array_equal(rcm_permutation(ds.adj), j_perm(ds_j.adj))
    got, exp = reorder_rcm(ds), j_reorder(ds_j)
    assert (got.adj != exp.adj).nnz == 0
    for f in ("features", "ano_labels", "idx_train", "idx_val", "idx_test",
              "normal_label_idx", "abnormal_label_idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), f)
    assert tile_occupancy(got.adj) == j_occupancy(exp.adj)
    assert tile_occupancy(got.adj, 32) == j_occupancy(exp.adj, 32)


def test_to_scipy_and_coalesce_equal_jax():
    row, col, val = random_coo(seed=21)
    g, gj = pg.from_coo(row, col, val, N, device="cpu"), jg.from_coo(
        row, col, val, N)
    assert (pg.to_scipy(g) != jg.to_scipy(gj)).nnz == 0
    for a, b in zip(pg.coalesce(row, col, val, N),
                    jg.coalesce(row, col, val, N)):
        np.testing.assert_array_equal(a, b)


def test_auto_routes_tile_sparse_graphs_to_ell():
    """``spmm_impl='auto'`` on the elliptic-shaped graph at scale 0.3
    (13,969 nodes, about 6 edges per occupied tile) builds the ELL table,
    subset and seed tables and trains; at scale 0.05 (about 33 a tile)
    the graph takes BCSR. No kernel is launched on the CPU."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_like
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer, spmm_route

    ds = synthetic_like("elliptic", scale=0.3)
    assert ds.n_nodes == 13_969
    tr = FullBatchTrainer(ds, embedding_dim=16, num_epoch=2, eval_every=1,
                          device="cpu")
    assert isinstance(tr.adj, pe.ELLGraph) and tr.adj.tables.bwd is None
    assert tr.adj.layout == "sigma"
    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    res = tr.train()
    assert isinstance(tr.adj, pe.ELLGraph) and tr.adj.tables.bwd is not None
    assert isinstance(tr.aff_sub, pe.ELLAffinitySubset)
    assert isinstance(tr.seed_adj, pe.ELLGraph)
    assert tr.seed_adj.tables.fwd.n_rows == len(ds.abnormal_label_idx)
    assert tr.seed_adj.tables.bwd.n_rows == ds.n_nodes
    assert all(np.isfinite(r["loss"]) for r in res.history if "loss" in r)
    assert bcsr_spmm.launches == bcsr_sddmm_colsum.launches == 0
    small = synthetic_like("elliptic", scale=0.05)
    g = pg.from_scipy(small.adj, device="cpu")
    assert spmm_route(g, "auto") == "bcsr"
    assert spmm_route(tr.raw_adj, "auto", dtype="bfloat16") == "ell"
    assert [spmm_route(g, i) for i in ("coo", "bcsr", "ell")] == \
        ["coo", "bcsr", "ell"]
    assert isinstance(FullBatchTrainer(small, embedding_dim=16,
                                       device="cpu").adj, BCSRGraph)


def test_cli_drives_the_ell_route_and_reorder(tmp_path, capsys):
    """The CLI on the elliptic-shaped graph at scale 0.3: ``auto`` trains on
    the ELL route; ``--reorder`` (RCM) packs the tiles past 8 edges each,
    so ``auto`` takes BCSR; ``--spmm_impl ell`` serves the checkpoint."""
    from ggad_tpu_torch.cli import main as cli_main

    ck = str(tmp_path / "ck")
    base = ["--dataset", "elliptic", "--synthetic_scale", "0.3",
            "--embedding_dim", "16", "--device", "cpu"]
    records = []
    for extra in (["--checkpoint_dir", ck], ["--reorder"]):
        assert cli_main(base + ["--num_epoch", "2", "--eval_every", "1"]
                        + extra) == 0
        records.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    assert [r["spmm_route"] for r in records] == ["ell", "bcsr"]
    assert all(0.0 <= r["auc"] <= 1.0 for r in records)
    assert cli_main(base + ["--score_only", "--checkpoint_dir", ck,
                            "--spmm_impl", "ell"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["spmm_route"] == "ell" and out["ckpt_step"] == 1
    assert out["auc"] == pytest.approx(records[0]["auc"], abs=1e-6)
