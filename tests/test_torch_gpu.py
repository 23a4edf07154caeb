"""The port's CUDA kernels against their plain versions on the card, and
the training step's kernel launches.

Marked ``gpu``: each test decides inside its body whether a card is
present and skips without one. On a machine with an H100 run
``python -m pytest tests/test_torch_gpu.py -q``. Tolerances: K1 f32 1e-5,
bf16 2e-5 rel/abs (only the f32 summation order differs, as in
``test_torch_bcsr_spmm.py``); K2 on row-normalized operands (as the
affinity feeds it) f32 1e-5, bf16 1e-4 (the CSR walk sums lane slices,
then non-zeros, then lanes and warps, the plain version each tile's dot
products, then its columns, then the tiles: two orders of f32 sums of
terms bounded by |M[r,c]|, since the rows are unit vectors);
gradients and train-step losses on the card against the CPU 1e-4. The
ELL route (plain PyTorch, no hand-written kernel) is held on the card
against the same ops on the CPU: f32 values 1e-5, bf16 values and all
gradients 1e-4.
"""

import numpy as np
import pytest
import torch

import ggad_tpu_torch.graph as pg
from ggad_tpu_torch.ops import bcsr_sddmm as pk2
from ggad_tpu_torch.ops import bcsr_spmm as pb
from ggad_tpu_torch.ops.sddmm import l2_normalize_rows, tile_affinity_subset

pytestmark = pytest.mark.gpu

K2_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False    # true-f32 plain version
    return torch.device("cuda")


def random_graph(n, per_row, seed, device, *, empty_row=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, per_row * n)
    if empty_row:       # no edge lands in rows 128..255: an empty tile row
        rows = rows[(rows < 128) | (rows >= 256)]
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.random(rows.shape[0]).astype(np.float32)
    return pg.from_coo(rows, cols, vals, n, device=device)


def randn(*shape, device, seed=0):
    return torch.randn(*shape, device=device,
                       generator=torch.Generator(device).manual_seed(seed))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-5)])
@pytest.mark.parametrize("n,d,tr,empty_row", [
    (300, 40, 128, True), (700, 300, 256, False), (2100, 72, 1024, False)])
def test_kernel_matches_plain(cuda, dtype, tol, n, d, tr, empty_row):
    g = random_graph(n, 20, n, cuda, empty_row=empty_row)
    tiles = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=tr).tiles.fwd
    h = randn(n, d, device=cuda)
    before = pb.bcsr_spmm.launches
    out = pb.bcsr_matmul(tiles, h)
    torch.cuda.synchronize()
    assert pb.bcsr_spmm.launches == before + 1
    expect = pb.bcsr_spmm_plain(tiles, h)
    torch.testing.assert_close(out, expect, rtol=tol, atol=tol)
    if empty_row:
        assert torch.all(out[128:256] == 0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-5)])
def test_k1_on_transposed_and_rect_sets(cuda, dtype, tol):
    """K1 on the transposed tile set, and on both rectangular sets of a
    column subset, where the output rows differ from H's rows."""
    g = random_graph(700, 20, 5, cuda)
    pair = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=256).tiles
    h = randn(700, 96, device=cuda, seed=1)
    out = pb.bcsr_matmul(pair.bwd, h)
    torch.testing.assert_close(out, pb.bcsr_spmm_plain(pair.bwd, h),
                               rtol=tol, atol=tol)
    sub = tile_affinity_subset(g, np.arange(1, 700, 7), dtype=dtype,
                               tile_rows=256)
    u = sub.n_uniq
    out_u = pb.bcsr_matmul(sub.pair.bwd, h, u)              # [U × N] @ [N, d]
    torch.testing.assert_close(
        out_u, pb.bcsr_spmm_plain(sub.pair.bwd, h, u), rtol=tol, atol=tol)
    hu = randn(u, 96, device=cuda, seed=2)
    out_n = pb.bcsr_matmul(sub.pair.fwd, hu, 700)           # [N × U] @ [U, d]
    torch.testing.assert_close(
        out_n, pb.bcsr_spmm_plain(sub.pair.fwd, hu, 700), rtol=tol, atol=tol)
    assert out_u.shape == (u, 96) and out_n.shape == (700, 96)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,tr,empty_row", [
    (300, 40, 128, True), (700, 300, 256, False), (1100, 33, 1024, False)])
def test_k2_square_matches_plain(cuda, dtype, n, d, tr, empty_row):
    g = random_graph(n, 20, n + 1, cuda, empty_row=empty_row)
    tiles = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=tr).tiles.fwd
    e = l2_normalize_rows(randn(n, d, device=cuda, seed=3))
    before = pk2.bcsr_sddmm_colsum.launches
    out = pk2.sddmm_colsum(tiles, e, e)
    torch.cuda.synchronize()
    assert pk2.bcsr_sddmm_colsum.launches == before + 1
    expect = pk2.bcsr_sddmm_colsum_plain(tiles, e, e)
    torch.testing.assert_close(out, expect, rtol=K2_TOL[dtype],
                               atol=K2_TOL[dtype])
    if empty_row:
        assert torch.all(out[128:256] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_rect_matches_plain(cuda, dtype):
    """The labeled-column subset's ``[U × N]`` set, tall tiles, d = 300."""
    g = random_graph(2100, 30, 9, cuda)
    sub = tile_affinity_subset(g, np.arange(0, 2100, 6), dtype=dtype,
                               tile_rows=1024)
    e = l2_normalize_rows(randn(2100, 300, device=cuda, seed=4))
    tgt = e[sub.uniq].contiguous()
    out = pk2.sddmm_colsum(sub.pair.bwd, tgt, e)
    torch.testing.assert_close(
        out, pk2.bcsr_sddmm_colsum_plain(sub.pair.bwd, tgt, e),
        rtol=K2_TOL[dtype], atol=K2_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tr", [128, 256, 512, 1024])
@pytest.mark.parametrize("d", [20, 33, 40, 48, 300])
def test_csr_walks_at_every_width_and_height(cuda, dtype, tr, d):
    """Both CSR-walk kernels against their plain versions at ragged widths
    (row strides that are not whole 16-byte vectors: the wrapper's copy
    and K2's column mask), every tile height, an empty tile row, and the
    rectangular sets of a column subset, whose output rows differ from
    their operand rows (K1 both ways, K2 on the ``[U × N]`` set)."""
    tol = 1e-5 if dtype == "float32" else 2e-5
    g = random_graph(600, 16, d + tr, cuda, empty_row=True)
    tiles = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=tr,
                             transpose=False).tiles.fwd
    h = randn(600, d, device=cuda, seed=d)
    e = l2_normalize_rows(h)
    out = pb.bcsr_matmul(tiles, h)
    out2 = pk2.sddmm_colsum(tiles, e, e)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, pb.bcsr_spmm_plain(tiles, h),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(out2, pk2.bcsr_sddmm_colsum_plain(tiles, e, e),
                               rtol=K2_TOL[dtype], atol=K2_TOL[dtype])
    assert torch.all(out[128:256] == 0) and torch.all(out2[128:256] == 0)

    sub = tile_affinity_subset(g, np.arange(2, 600, 9), dtype=dtype,
                               tile_rows=tr)
    u = sub.n_uniq
    hu = randn(u, d, device=cuda, seed=d + 1)
    torch.testing.assert_close(pb.bcsr_matmul(sub.pair.bwd, h, u),
                               pb.bcsr_spmm_plain(sub.pair.bwd, h, u),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(pb.bcsr_matmul(sub.pair.fwd, hu, 600),
                               pb.bcsr_spmm_plain(sub.pair.fwd, hu, 600),
                               rtol=tol, atol=tol)
    tgt = e[sub.uniq].contiguous()
    torch.testing.assert_close(
        pk2.sddmm_colsum(sub.pair.bwd, tgt, e),
        pk2.bcsr_sddmm_colsum_plain(sub.pair.bwd, tgt, e),
        rtol=K2_TOL[dtype], atol=K2_TOL[dtype])


def test_kernels_read_operands_off_a_vector_boundary(cuda):
    """Operands that start 4 bytes past a 16-byte boundary (views into a
    larger tensor) are copied by the wrapper, not misread."""
    g = random_graph(300, 12, 3, cuda)
    tiles = pb.as_bcsr_graph(g, tile_rows=128, transpose=False).tiles.fwd
    base = randn(300 * 40 + 1, device=cuda, seed=7)
    h = base[1:].view(300, 40)
    assert h.data_ptr() % 16 == 4
    torch.testing.assert_close(pb.bcsr_matmul(tiles, h),
                               pb.bcsr_spmm_plain(tiles, h),
                               rtol=1e-5, atol=1e-5)
    e = l2_normalize_rows(h)
    torch.testing.assert_close(pk2.sddmm_colsum(tiles, h, e),
                               pk2.bcsr_sddmm_colsum_plain(tiles, h, e),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_on_the_card_matches_the_cpu(cuda, dtype):
    """``bcsr_spmm`` and both K2 ops: gradients on the card (K1 launches in
    the backward) against the same ops on the CPU (plain versions)."""
    g = random_graph(700, 20, 13, "cpu")
    idx = np.arange(0, 700, 5)
    w = torch.randn(700, 64, generator=torch.Generator().manual_seed(5))
    h0 = torch.randn(700, 64, generator=torch.Generator().manual_seed(6))

    def grads(device):
        gd = pg.from_coo(*g.host_coo(), 700, device=device)
        pair = pb.as_bcsr_graph(gd, dtype=dtype, tile_rows=256).tiles
        sub = tile_affinity_subset(gd, idx, dtype=dtype, tile_rows=256)
        h = h0.to(device).requires_grad_()
        e = l2_normalize_rows(h)
        loss = ((pb.bcsr_spmm(pair, h) * w.to(device)).sum()
                + pk2.bcsr_sddmm_colsum(pair, e).square().sum()
                + pk2.bcsr_sddmm_colsum_rect(
                    sub.pair, e[sub.uniq], e).sin().sum())
        loss.backward()
        return h.grad.cpu()

    k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
    on_card = grads(cuda)
    torch.cuda.synchronize()
    # forward: 1 K1 + 2 K2; backward: 1 K1 + 2 × 2 K1
    assert pb.bcsr_spmm.launches - k1 == 6
    assert pk2.bcsr_sddmm_colsum.launches - k2 == 2
    torch.testing.assert_close(on_card, grads("cpu"), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_launches_and_losses(cuda, dtype):
    """One step launches K1 twice in f32 and K1 four times plus K2 once in
    bf16; its losses equal the CPU's with the same weights and noise."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    ds = synthetic_gad(n_nodes=1500, avg_degree=20, feat_dim=64,
                       n_communities=4, anomaly_rate=0.1, seed=1)
    losses = {}
    for device in (cuda, "cpu"):
        tr = FullBatchTrainer(ds, embedding_dim=96, spmm_impl="bcsr",
                              spmm_dtype=dtype, noise_mean=0.02,
                              noise_std=0.0, device=device)
        tr.model.load_state_dict(tr.init())
        k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
        losses[str(device)] = tr.train_step(
            torch.Generator(tr.device).manual_seed(0))
        if device == cuda:
            torch.cuda.synchronize()
            assert pb.bcsr_spmm.launches - k1 == (2 if dtype == "float32"
                                                  else 4)
            assert pk2.bcsr_sddmm_colsum.launches - k2 == (
                0 if dtype == "float32" else 1)
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert a.item() == pytest.approx(b.item(), rel=1e-4, abs=1e-4)


def ell_graph_coo(n=2000, seed=0):
    """Degrees 0..23 (every sigma bucket from K 2 to 32 above the 256-row
    floor, some empty rows) and one hub row of degree 150 past the cap of
    64, whose tail is the COO residual."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 24, n)
    deg[7] = 150
    row = np.repeat(np.arange(n), deg)
    col = rng.integers(0, n, row.shape[0])
    val = rng.random(row.shape[0]).astype(np.float32)
    return row, col, val


def ell_ops(device, dtype, d, coo):
    """The ELL products on ``device``: sigma and flat ``ell_spmm``, the
    square affinity column sums and the labeled-subset column sums, and
    the gradients of one loss over all four, on the CPU. Every input and
    cotangent is made on the CPU, so both devices round the same f32
    values to bf16 (a value one f32 ulp apart can round to another bf16)."""
    from ggad_tpu_torch.ops import ell_spmm as pe

    n = 2000
    g = pg.add_self_loops(pg.from_coo(*coo, n, device=device))
    sigma = pe.as_ell_graph(g, layout="sigma", dtype=dtype).tables
    flat = pe.as_ell_graph(g, dtype=dtype).tables
    sub = pe.ell_affinity_subset(g, np.arange(3, n, 7), dtype=dtype)
    assert sigma.fwd.n_overflow and flat.fwd.n_overflow
    gen = torch.Generator().manual_seed(d)
    x0 = torch.randn(n, d, generator=gen)
    x = x0.to(device, copy=True).requires_grad_()
    e = l2_normalize_rows(x0).to(device, copy=True).requires_grad_()
    outs = [pe.ell_spmm(sigma, x), pe.ell_spmm(flat, x),
            pe.ell_affinity_colsum(sigma, e), pe.ell_subset_colsum(sub, e)]
    cots = [torch.randn(o.shape, generator=gen).to(device) for o in outs]
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    return [o.detach().cpu() for o in outs] + [x.grad.cpu(), e.grad.cpu()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [20, 33, 300])
def test_ell_ops_on_the_card_match_the_cpu(cuda, dtype, d):
    """The ELL route's products and column sums, values and gradients, on
    the card against the same ops on the CPU (the same rounding points;
    the sums run in another order): 1e-5 f32 values, 1e-4 otherwise. No
    hand-written kernel is launched."""
    coo = ell_graph_coo()
    k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
    on_card = ell_ops(cuda, dtype, d, coo)
    torch.cuda.synchronize()
    assert (pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches) == (k1, k2)
    on_cpu = ell_ops("cpu", dtype, d, coo)
    tol = 1e-5 if dtype == "float32" else 1e-4
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        t = tol if i < 4 else 1e-4
        torch.testing.assert_close(a, b, rtol=t, atol=t)
    assert on_card[1].shape == (2000, d) and on_card[3].shape == (286,)


def test_ell_chunked_gathers_on_the_card(cuda, monkeypatch):
    """Bucket gathers and the residual split into row chunks on the card
    give the CPU's values (1e-5) and gradients (1e-4)."""
    from ggad_tpu_torch.ops import ell_spmm as pe

    coo = ell_graph_coo(seed=1)
    monkeypatch.setattr(pe, "_OV_CHUNK_ELEMS", 1 << 14)
    on_card = ell_ops(cuda, "float32", 300, coo)
    on_cpu = ell_ops("cpu", "float32", 300, coo)
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        t = 1e-5 if i < 4 else 1e-4
        torch.testing.assert_close(a, b, rtol=t, atol=t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_train_step_on_the_card_matches_the_cpu(cuda, dtype):
    """One train step on the ELL route (sigma tables for gcn2, the seed
    aggregation and the margin's subset) launches neither kernel; its
    losses equal the CPU's with the same weights and noise (1e-4)."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.ops.ell_spmm import ELLAffinitySubset, ELLGraph
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    ds = synthetic_gad(n_nodes=1500, avg_degree=20, feat_dim=64,
                       n_communities=4, anomaly_rate=0.1, seed=1)
    losses = {}
    for device in (cuda, "cpu"):
        tr = FullBatchTrainer(ds, embedding_dim=96, spmm_impl="ell",
                              spmm_dtype=dtype, noise_mean=0.02,
                              noise_std=0.0, device=device)
        tr.model.load_state_dict(tr.init())
        k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
        losses[str(device)] = tr.train_step(
            torch.Generator(tr.device).manual_seed(0))
        assert isinstance(tr.adj, ELLGraph)
        assert isinstance(tr.seed_adj, ELLGraph)
        assert isinstance(tr.aff_sub, ELLAffinitySubset)
        if device == cuda:
            torch.cuda.synchronize()
            assert (pb.bcsr_spmm.launches - k1,
                    pk2.bcsr_sddmm_colsum.launches - k2) == (0, 0)
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert a.item() == pytest.approx(b.item(), rel=1e-4, abs=1e-4)


def minibatch_trainer(device, **kw):
    """A small DGraph-shaped minibatch trainer (17 features, emb 64,
    fanouts 16/8, batch 150 + 50) on ``device``, seeded init."""
    import scipy.sparse as sp

    from ggad_tpu_torch.datasets.splits import minibatch_split_for
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    ds = synthetic_gad(n_nodes=3000, avg_degree=9, feat_dim=17, seed=1)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split_for(
        "dgraphfin", ds.ano_labels, seed=0)
    return MiniBatchTrainer(adj=adj, features=ds.features, labels=labels,
                            idx_train=idx_train, idx_anomaly=idx_anom,
                            idx_valid=idx_valid, idx_test=idx_test,
                            num_batches=3, eval_batch=256, device=device,
                            **kw)


@pytest.mark.parametrize("agg", ["gcn", "mean"])
def test_minibatch_ops_on_the_card_match_the_cpu(cuda, agg):
    """The sampler, the train-branch forward, its losses and gradients on
    the card against the CPU, from the same weights and draws: ids and
    masks equal, values 1e-5, losses and gradients 1e-4. No hand-written
    kernel is launched."""
    from ggad_tpu_torch.models.sage import MiniBatchGGAD, minibatch_ggad_losses
    from ggad_tpu_torch.sampler.neighbor import sample_two_hop

    gen = torch.Generator().manual_seed(0)
    init = MiniBatchGGAD(17, 64, 16, 8, agg, generator=gen).state_dict()
    batch = torch.randint(0, 3000, (200,), generator=gen, dtype=torch.int32)
    u1 = torch.rand(200, 16, generator=gen)
    u2 = torch.rand(3200, 8, generator=gen)
    k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
    res = []
    for device in (cuda, "cpu"):
        tr = minibatch_trainer(device)
        model = MiniBatchGGAD(17, 64, 16, 8, agg).to(device)
        model.load_state_dict(init)
        args = (tr.feats, tr.table, batch.to(device), 50, True)
        out = model(*args, u1=u1.to(device), u2=u2.to(device))
        losses = minibatch_ggad_losses(out, 50)
        losses.total.backward()
        ids = sample_two_hop(tr.table, batch.to(device), 16, 8,
                             u1.to(device), u2.to(device))
        res.append(([t.cpu() for t in ids],
                    [t.detach().cpu() for t in out],
                    [t.detach().cpu() for t in losses],
                    [p.grad.cpu() for p in model.parameters()]))
    torch.cuda.synchronize()
    assert (pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches) == (k1, k2)
    card, cpu = res
    for a, b in zip(card[0], cpu[0]):
        assert torch.equal(a, b)
    for a, b in zip(card[1], cpu[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(card[2] + card[3], cpu[2] + cpu[3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_minibatch_steps_and_scores_on_the_card_match_the_cpu(cuda):
    """Three AdamW steps from the same init, batches and draws (made on the
    CPU), then ``score_nodes`` on the same draws: the card within 1e-4 of
    the CPU, no hand-written kernel launched."""
    gen = torch.Generator().manual_seed(1)
    u1 = torch.rand(3, 200, 16, generator=gen)
    u2 = torch.rand(3, 3200, 8, generator=gen)
    ue = torch.rand(4, 256, 16, generator=gen)
    k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
    res = []
    for device in (cuda, "cpu"):
        tr = minibatch_trainer(device, draws=lambda shape: ue)
        batches = tr.draw_batches(np.random.default_rng(0))
        losses = [torch.stack(list(tr.train_step(batches[i], u1[i].to(device),
                                                 u2[i].to(device)))).cpu()
                  for i in range(3)]
        ids = np.random.default_rng(1).integers(0, 3000, 1000)
        res.append((losses, tr.score_nodes(None, ids)))
    torch.cuda.synchronize()
    assert (pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches) == (k1, k2)
    (card_losses, card_scores), (cpu_losses, cpu_scores) = res
    for a, b in zip(card_losses, cpu_losses):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-5)])
@pytest.mark.parametrize("d", [745, 7])
def test_k1_at_widths_off_the_vector(cuda, dtype, tol, d):
    """K1 at AEGIS's ``gcn_dec2`` width (the photo shape's 745 features)
    and at a small odd width: the operand is copied to a whole-vector
    stride and the kernel stores its tail column by column."""
    g = random_graph(1200, 20, d, cuda)
    pair = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=256).tiles
    h = randn(1200, d, device=cuda, seed=d)
    before = pb.bcsr_spmm.launches
    outs = [pb.bcsr_matmul(pair.fwd, h), pb.bcsr_matmul(pair.bwd, h)]
    torch.cuda.synchronize()
    assert pb.bcsr_spmm.launches == before + 2
    for tiles, out in zip((pair.fwd, pair.bwd), outs):
        torch.testing.assert_close(out, pb.bcsr_spmm_plain(tiles, h),
                                   rtol=tol, atol=tol)


def k1_route_cases(case, dtype, device):
    """(tile store, H, output rows) for ``test_k1_routes_match_plain``."""
    rng = np.random.default_rng(11)
    n = 1100
    rows = rng.integers(0, n, (150 if case == "dense tiles" else 12) * n)
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.uniform(0.25, 1.5, rows.shape[0]).astype(np.float32)
    if case == "heavy row":     # row 700 holds every column, values / n
        rows = np.r_[rows, np.full(n, 700)]
        cols = np.r_[cols, np.arange(n)]
        vals = np.r_[vals, rng.uniform(0.25, 1.5, n).astype(np.float32) / n]
        tiles = pb.as_bcsr_graph(pg.from_coo(rows, cols, vals, n,
                                             device=device), dtype=dtype,
                                 tile_rows=1024).tiles.fwd
        return tiles, randn(n, 300, device=device, seed=1), n
    if case == "remote past h_rows":
        # [R × W] with H of W - 70 rows: the last 70 columns read zeros
        keep = rows < 500
        tiles = pb.bcsr_rect_from_coo(rows[keep], cols[keep], vals[keep],
                                      500, n, dtype=dtype, tile_rows=512,
                                      device=device)
        return tiles, randn(n - 70, 300, device=device, seed=2), 500
    d = 300 if case == "dense tiles" else int(case.split()[-1])
    tiles = pb.as_bcsr_graph(pg.from_coo(rows, cols, vals, n, device=device),
                             dtype=dtype, tile_rows=512).tiles.fwd
    return tiles, randn(n, d, device=device, seed=d), n


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-5)])
@pytest.mark.parametrize("case", ["heavy row", "remote past h_rows",
                                  "ragged d 1", "ragged d 25",
                                  "ragged d 745", "dense tiles"])
def test_k1_routes_match_plain(cuda, dtype, tol, case):
    """Both routes of K1, the walk and the staged route, against the plain
    version, whichever route the store's shape picks: a tile with one row
    that holds every column, a remote rect set whose last columns lie past
    H's rows (they read zeros), widths off the column chunks, and tiles
    dense enough that each band-tile fills several entry blocks. The two
    routes agree exactly on every row but the walk's heavy rows: each such
    element is the same FMA chain over ascending columns (a heavy row is
    eight chains added in order). Each launch is counted on its route."""
    tiles, h, n_out = k1_route_cases(case, dtype, cuda)
    expect = pb.bcsr_spmm_plain(tiles, h, n_out)
    kind = "f32" if dtype == "float32" else "bf16"
    outs = []
    for view in (None, pb.tile_view(tiles)):
        route = ("walk" if view is None else "staged") + "_" + kind
        before = dict(pb.bcsr_spmm.routes)
        outs.append(pb.bcsr_spmm_cuda(tiles, h, n_out, view=view))
        torch.cuda.synchronize()
        assert pb.bcsr_spmm.routes[route] == before[route] + 1
        torch.testing.assert_close(outs[-1], expect, rtol=tol, atol=tol)
    light = torch.ones(n_out, dtype=torch.bool, device=cuda)
    heavy = tiles.heavy[1].long()
    light[heavy[heavy < n_out]] = False
    assert torch.equal(outs[0][light], outs[1][light])   # one FMA chain
    assert (case == "heavy row") == (not bool(light.all()))
    assert tiles.route == pb.k1_route(tiles)
    own = pb.bcsr_matmul(tiles, h, n_out)
    torch.testing.assert_close(own, expect, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_launch_shape_comes_from_the_kernel(cuda, dtype):
    """The staged kernel's own layout is the one ``tile_view`` builds for,
    and ``k1_launch_shape`` takes a launch's blocks, threads and shared
    memory from the kernel: a block per 128-row band and 64-column chunk,
    16 consumer warps and a producer, a ring of 3 slabs and entry
    blocks."""
    tiles, h, n_out = k1_route_cases("dense tiles", dtype, cuda)
    item, d = tiles.values.element_size(), h.shape[1]
    pb.check_layout(item)
    got = pb.staged_describe(item, n_out, d)
    assert ({k: got[k] for k in ("slots", "band", "chunk", "stages",
                                 "block_words", "slab_rows")}
            == {"slots": pb.WARP_ROWS, "band": pb.BAND,
                "chunk": pb.STAGED_CHUNK, "stages": pb.STAGED_STAGES,
                "block_words": pb.STAGED_BLOCK_WORDS, "slab_rows": 128})
    assert got["blocks"] == -(-n_out // pb.BAND) * -(-d // pb.STAGED_CHUNK)
    assert got["threads"] == 32 * (pb.BAND // pb.WARP_ROWS + 1)
    assert got["smem_bytes"] == (pb.STAGED_STAGES * (128 * pb.STAGED_CHUNK
                                                     * item + 4 *
                                                     pb.STAGED_BLOCK_WORDS)
                                 + 2 * pb.STAGED_STAGES * 8 + 1024)
    shape = pb.k1_launch_shape(tiles, d, n_out, pb.tile_view(tiles))
    assert {k: shape[k] for k in ("blocks", "threads", "smem_bytes")} == {
        k: got[k] for k in ("blocks", "threads", "smem_bytes")}


def zoo_run(device, name, faithful, init=None):
    """An OCGNN or AEGIS run on a small graph with 21 features (AEGIS's
    decoder width is off the vector), on the BCSR route, with fixed
    noise."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.train import baselines as tb

    ds = synthetic_gad(n_nodes=600, avg_degree=12, feat_dim=21,
                       n_communities=4, anomaly_rate=0.1, seed=2)
    kw = dict(embedding_dim=40, spmm_impl="bcsr", device=device,
              initial_params=init)
    if name == "ocgnn":
        return tb.OCGNNRun(ds, **kw)
    noise = [np.random.default_rng(i).standard_normal(
        (600, 16)).astype(np.float32) for i in range(2)]
    return tb.AEGISRun(ds, faithful=faithful, noise_seq=noise, **kw)


def zoo_steps(run, name):
    """OCGNN: two steps, then an evaluation; AEGIS: a pretrain step, then
    an adversarial step and its scores. Each call's result and its K1
    launches."""
    calls = (["step", "step"] if name == "ocgnn"
             else ["pretrain_step", "step"]) + ["scores"]
    out = []
    for call in calls:
        before = pb.bcsr_spmm.launches
        val = getattr(run, call)().cpu()
        out.append((call, val, pb.bcsr_spmm.launches - before))
    return out


@pytest.mark.parametrize("name,faithful", [("ocgnn", False),
                                           ("aegis", False),
                                           ("aegis", True)])
def test_zoo_steps_on_the_card_match_the_cpu(cuda, name, faithful):
    """OCGNN and AEGIS steps from the same weights (the card run's seeded
    init, copied to the CPU) and noise: losses and scores on the card
    within 1e-4 of the CPU, with K1's exact launches (OCGNN 4 a step, 2 an
    evaluation; AEGIS 10 a pretrain step, 12 an adversarial one, whose
    scores come from the step)."""
    want = {"step": 4 if name == "ocgnn" else 12, "pretrain_step": 10,
            "scores": 2 if name == "ocgnn" else 0}
    card_run = zoo_run(cuda, name, faithful)
    init = {k: v.cpu().clone() for k, v in card_run.model.state_dict().items()}
    card = zoo_steps(card_run, name)
    torch.cuda.synchronize()
    assert [n for _, _, n in card] == [want[c] for c, _, _ in card]
    cpu = zoo_steps(zoo_run("cpu", name, faithful, init), name)
    assert all(n == 0 for _, _, n in cpu)
    for (_, a, _), (_, b, _) in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def tam_inputs(device):
    """A small tile-dense graph with self-loops, its features and labeled
    normals, three members' cut values (seeded cuts on the CPU) and their
    seeded stacked init."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.models import tam

    ds = synthetic_gad(n_nodes=700, avg_degree=12, feat_dim=40,
                       anomaly_rate=0.08, seed=2)
    raw = pg.add_self_loops(pg.from_scipy(ds.adj, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    params = tam.init_members(ds.feat_dim, 24, 3, gen)
    vals = tam.cut_stack(raw, torch.as_tensor(ds.features), 3, 1,
                         [torch.rand(ds.n_nodes, generator=gen)
                          for _ in range(3)])
    return ds, pg.add_self_loops(pg.from_scipy(ds.adj, device=device)), \
        vals, params


@pytest.mark.parametrize("d", [600, 33])
def test_tam_blockdiag_k1_matches_plain(cuda, d):
    """K1 on TAM's block-diagonal tile pair, forward and transposed, at a
    whole-vector and a ragged width: one launch each, within 1e-5 of its
    plain version."""
    from ggad_tpu_torch.models import tam

    ds, raw, vals, _ = tam_inputs(cuda)
    pair = tam.blockdiag_pair(raw, tam.sym_normalize_vals(vals.to(cuda), raw),
                              256)
    h = randn(pair.fwd.n_cols, d, device=cuda)
    for tiles in (pair.fwd, pair.bwd):
        before = pb.bcsr_spmm.launches
        out = pb.bcsr_matmul(tiles, h)
        torch.cuda.synchronize()
        assert pb.bcsr_spmm.launches == before + 1
        torch.testing.assert_close(out, pb.bcsr_spmm_plain(tiles, h),
                                   rtol=1e-5, atol=1e-5)


def test_tam_run_on_the_card_matches_the_cpu(cuda):
    """``run_tam`` on the card's block-diagonal route (K1: 4 launches an
    epoch for one chunk, 8 for two) against the CPU's ELL route from the
    same cut values and weights: scores, messages and recorded losses
    within 1e-4."""
    from ggad_tpu_torch.models import tam

    ds, raw, vals, params = tam_inputs(cuda)
    kw = dict(n_h=24, cutting=3, num_epoch=4, lr=1e-4, val_stack=vals,
              member_params=params, loss_record=range(4))
    cpu = tam.run_tam(pg.add_self_loops(pg.from_scipy(ds.adj, device="cpu")),
                      ds.features, ds.normal_label_idx, impl="ell", **kw)
    for chunk, launches in ((None, 16), (2, 32)):
        before = pb.bcsr_spmm.launches
        card = tam.run_tam(raw, ds.features, ds.normal_label_idx,
                           impl="bcsr", member_chunk=chunk, **kw)
        assert pb.bcsr_spmm.launches - before == launches
        for field in ("scores", "per_round_scores", "member_messages"):
            np.testing.assert_allclose(getattr(card, field),
                                       getattr(cpu, field), rtol=1e-4,
                                       atol=1e-4, err_msg=field)
        for ep, losses in cpu.loss_history.items():
            np.testing.assert_allclose(card.loss_history[ep], losses,
                                       rtol=1e-4, atol=1e-4)


class FixedDraws:
    """A draw source that gives the same sequence of draws on every
    device: each request is a fresh CPU draw of one seeded generator."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, shape):
        return torch.rand(shape, generator=self.gen)


def mb_baseline_inputs():
    import scipy.sparse as sp

    from ggad_tpu_torch.datasets.splits import minibatch_split
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad

    ds = synthetic_gad(n_nodes=3000, avg_degree=8, feat_dim=17,
                       n_relations=3, seed=1)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split(
        ds.ano_labels, seed=0)
    return ds, dict(adj=adj, features=ds.features, labels=labels,
                    idx_train=idx_train, idx_valid=idx_valid,
                    idx_test=idx_test)


@pytest.mark.parametrize("name,relations", [
    ("sage", False), ("pcgnn", False), ("pcgnn", True),
    ("dominant-minibatch", False), ("anomalydae-minibatch", False),
    ("aegis-minibatch", False)])
def test_minibatch_baselines_on_the_card_match_the_cpu(cuda, name,
                                                       relations):
    """Three steps of each minibatch baseline from the same init, batch
    ids, draws (and AEGIS-mb's noise table), then 1,000 scores: the card
    within 1e-4 of the CPU, no hand-written kernel launched."""
    from ggad_tpu_torch.datasets.splits import minibatch_split
    from ggad_tpu_torch.train import baselines as tb

    ds, inputs = mb_baseline_inputs()
    kw = dict(emb_dim=64, num_batches=3)
    if name in ("sage", "pcgnn"):
        cls = tb.MiniBatchClassifierRun
        kw.update(idx_anomaly=minibatch_split(ds.ano_labels, seed=0)[4],
                  relations=ds.relations if relations else None)
    else:
        cls = tb.MiniBatchReconRun
    k1, k2 = pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches
    ids = np.random.default_rng(1).integers(0, 3000, 1000)
    extra, res = {}, []
    for device in (cuda, "cpu"):
        run = cls(**inputs, name=name, draws=FixedDraws(0), device=device,
                  **kw, **extra)
        extra = dict(initial_params={k: v.clone() for k, v in
                                     run.model.state_dict().items()})
        if name == "aegis-minibatch":
            extra["noise_table"] = run.noise_table
        run.train_epoch(*run.draw_batches(np.random.default_rng(0)))
        res.append((torch.stack(run.losses).cpu(), run.score_nodes(ids)))
    torch.cuda.synchronize()
    assert (pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches) == (k1, k2)
    (card_losses, card_scores), (cpu_losses, cpu_scores) = res
    torch.testing.assert_close(card_losses, cpu_losses, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=1e-4, atol=1e-4)


def test_exact_replay_on_the_card_matches_the_cpu(cuda):
    """Three coupled-Adam steps of the exact set-union replay and its
    150-node eval slices on the card against the CPU: 1e-4."""
    from ggad_tpu_torch.models import sage_exact as px

    ds, inputs = mb_baseline_inputs()
    indptr, indices = px.replay_adjacency(ds.adj)
    rng = np.random.default_rng(0)
    batches = [(rng.choice(3000, 200, replace=False),
                np.r_[np.zeros(150), np.ones(50)]) for _ in range(3)]
    pads = px.exact_pads(indptr, indices, [b[0] for b in batches])
    init = px.init_exact_params(17, 64, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    res = []
    for device in (cuda, "cpu"):
        params = {k: v.detach().to(device, copy=True).requires_grad_()
                  for k, v in init.items()}
        feats = torch.as_tensor(ds.features).to(device)
        opt = torch.optim.Adam(params.values(), lr=1e-3, weight_decay=0.007)
        losses = []
        for nodes, labels in batches:
            b = px.build_exact_batch(indptr, indices, nodes, labels, *pads,
                                     device=device)
            opt.zero_grad()
            total, _ = px.exact_losses(params, feats, b)
            total.backward()
            opt.step()
            losses.append(total.item())
        res.append((losses, px.exact_score_nodes(
            params, feats, indptr, indices, np.arange(400))))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-4, atol=1e-4)


def test_rwr_on_the_card_equals_the_cpu(cuda):
    """The same draws give the same walk subgraphs and ``pick_step`` ids
    on the card as on the CPU."""
    from ggad_tpu_torch.sampler import rwr
    from ggad_tpu_torch.sampler.neighbor import NeighborTable

    _, inputs = mb_baseline_inputs()
    gen = torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 3000, (500,), generator=gen, dtype=torch.int32)
    u_step, u_restart = torch.rand(2, 12, 500, generator=gen)
    idx = torch.as_tensor(inputs["idx_train"])
    y = torch.as_tensor(inputs["labels"])[idx]
    u = torch.rand(2000, generator=gen)
    out = []
    for device in (cuda, "cpu"):
        table = NeighborTable.from_scipy(inputs["adj"], device=device)
        nodes, mask = rwr.rwr_subgraphs(
            table, seeds.to(device), subgraph_size=4,
            u_step=u_step.to(device), u_restart=u_restart.to(device))
        deg = table.degrees_of(idx.to(device))
        picked = rwr.pick_step(idx.to(device), y.to(device), deg,
                               u.to(device))
        out.append([t.cpu() for t in (nodes, mask, picked)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def halo_pair(device, D=4, schedule="ring", dtype="float32"):
    """The halo structures of one seeded graph on ``device``, built on
    the host and placed (the same host build for the card and the CPU)."""
    from ggad_tpu_torch.graph import add_self_loops, from_scipy
    from ggad_tpu_torch.parallel import spmm_shard as ss
    from ggad_tpu_torch.parallel.mesh import make_mesh

    import scipy.sparse as sp

    mat = sp.random(900, 900, density=0.02, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(2))
    g = add_self_loops(from_scipy(sp.csr_matrix(mat + mat.T), device="cpu"))
    mesh = make_mesh(D, device=device)
    part = ss.partition_edges(g, D)
    plan = ss.build_halo_plan(part, schedule)
    idx = np.random.default_rng(0).choice(900, 200, replace=False)
    return dict(
        mesh=mesh, part=ss.place_partition(part, mesh),
        plan=ss.place_halo_plan(plan, mesh),
        tiles=ss.place_halo_bcsr(ss.build_halo_bcsr(part, plan, dtype=dtype),
                                 mesh),
        sub=ss.place_halo_affinity_subset(
            ss.build_halo_affinity_subset(part, idx, tiles_dtype=dtype),
            mesh),
        ells=ss.place_halo_ell(ss.build_halo_ell(part, plan), mesh),
        x=ss.place_nodes(ss.pad_nodes(torch.from_numpy(
            np.random.default_rng(1).normal(size=(900, 40))
            .astype(np.float32)), part), mesh))


HALO_LAUNCHES = {"spmm_halo_bcsr": (4, 0), "affinity_halo_bcsr": (4, 2),
                 "affinity_halo_subset": (2, 1)}   # (K1, K2) a shard, fwd + bwd


@pytest.mark.parametrize("op,dtype", [
    *((op, dt) for op in HALO_LAUNCHES for dt in ("float32", "bfloat16")),
    ("spmm_halo_ell", "float32"), ("spmm_halo", "float32"),
    ("affinity_halo", "float32")])
def test_halo_ops_on_the_card_match_the_cpu(cuda, op, dtype):
    """Each halo op and its input gradient on the card (K1/K2 on each
    shard's rect tiles, counted exactly) against the plain versions on
    the CPU: f32 1e-5 values and 1e-4 gradients, bf16 1e-4."""
    from ggad_tpu_torch.parallel import spmm_shard as ss

    calls = {
        "spmm_halo_bcsr": lambda s, h: ss.spmm_halo_bcsr(
            s["part"], s["plan"], s["tiles"], h, s["mesh"]),
        "affinity_halo_bcsr": lambda s, h: ss.affinity_halo_bcsr(
            s["part"], s["plan"], s["tiles"], h, s["mesh"]),
        "affinity_halo_subset": lambda s, h: ss.affinity_halo_subset(
            s["plan"], s["sub"], h, s["mesh"]),
        "spmm_halo_ell": lambda s, h: ss.spmm_halo_ell(
            s["part"], s["plan"], s["ells"], h, s["mesh"]),
        "spmm_halo": lambda s, h: ss.spmm_halo(s["part"], s["plan"], h,
                                               s["mesh"]),
        "affinity_halo": lambda s, h: ss.affinity_halo(s["part"], s["plan"],
                                                       h, s["mesh"])}
    res = []
    for device in (cuda, "cpu"):
        s = halo_pair(device, dtype=dtype)
        h = s["x"].clone().requires_grad_(True)
        before = (pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches)
        out = calls[op](s, h)
        torch.sin(out).sum().backward()
        res.append((out.detach().cpu(), h.grad.cpu()))
        if device is cuda:
            k1, k2 = HALO_LAUNCHES.get(op, (0, 0))
            assert (pb.bcsr_spmm.launches - before[0],
                    pk2.bcsr_sddmm_colsum.launches - before[1]) == (4 * k1,
                                                                   4 * k2)
    tol = (1e-5, 1e-4) if dtype == "float32" else (1e-4, 1e-4)
    torch.testing.assert_close(res[0][0], res[1][0], rtol=tol[0],
                               atol=tol[0])
    torch.testing.assert_close(res[0][1], res[1][1], rtol=tol[1],
                               atol=tol[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_train_step_on_the_card_matches_the_cpu(cuda, dtype):
    """Two steps and an evaluation of ``FullBatchTrainer(mesh=4)`` on the
    BCSR route: per step 6 K1 and 1 K2 a shard on the card; losses and
    scores against the CPU within 1e-4·(1 + |CPU|)."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    ds = synthetic_gad(n_nodes=900, avg_degree=10, feat_dim=24,
                       n_communities=3, seed=4)
    res = {}
    for device in (cuda, "cpu"):
        tr = FullBatchTrainer(ds, embedding_dim=48, spmm_impl="bcsr",
                              spmm_dtype=dtype, mesh=4, noise_mean=0.02,
                              noise_std=0.0, device=device)
        assert tr.route == "bcsr"
        tr.model.load_state_dict(tr.init())
        gen = torch.Generator(tr.device).manual_seed(0)
        before = (pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches)
        losses = [[float(x) for x in tr.train_step(gen)] for _ in range(2)]
        scores = tr.eval_scores()
        if device is cuda:
            assert (pb.bcsr_spmm.launches - before[0],
                    pk2.bcsr_sddmm_colsum.launches - before[1]) == (
                        2 * 4 * 6 + 4 * 2, 2 * 4)
        res[str(device)] = (np.array(losses), scores)
    card, cpu = res[str(cuda)], res["cpu"]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-4, atol=1e-4)


# -- the rest of the multi-device paths: DP minibatch, GSPMD, 2-D TP ------

def _launches():
    return pb.bcsr_spmm.launches, pk2.bcsr_sddmm_colsum.launches


def test_dp_minibatch_step_on_the_card_matches_the_cpu(cuda):
    """``MiniBatchTrainer(mesh=4)``: two steps from the seeded init on the
    same batches and draws, then scores on one draw; losses, gradients and
    scores on the card against the CPU within 1e-4; K1 = K2 = 0."""
    import scipy.sparse as sp

    from ggad_tpu_torch.datasets.splits import minibatch_split
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    ds = synthetic_gad(n_nodes=2000, avg_degree=8, feat_dim=17, seed=3)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split(
        ds.ano_labels, seed=0, pseudo_anomaly_frac=0.1)
    gen = torch.Generator().manual_seed(0)
    u1 = torch.rand(2, 200, 16, generator=gen)
    u2 = torch.rand(2, 200 * 16, 8, generator=gen)
    ue = torch.rand(2, 1024, 16, generator=gen)
    res = {}
    for device in (cuda, "cpu"):
        tr = MiniBatchTrainer(
            adj=adj, features=ds.features, labels=labels,
            idx_train=idx_train, idx_anomaly=idx_anom, idx_valid=idx_valid,
            idx_test=idx_test, emb_dim=64, num_batches=2, eval_batch=1024,
            mesh=4, device=device)
        batches = tr.draw_batches(np.random.default_rng(0))
        before = _launches()
        losses, grads = [], []
        for i in range(2):
            losses.append([float(x) for x in tr.train_step(
                batches[i], u1[i].to(tr.device), u2[i].to(tr.device))])
            grads.append({k: p.grad.cpu()
                          for k, p in tr.model.named_parameters()})
        tr.draws = lambda shape: ue[:shape[0]]    # one draw on both
        scores = tr.score_nodes(None, idx_valid[:2048])
        assert _launches() == before
        res[str(device)] = (np.array(losses), grads, scores)
    card, cpu = res[str(cuda)], res["cpu"]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4, atol=1e-4)
    for g_card, g_cpu in zip(card[1], cpu[1]):
        for k, v in g_cpu.items():
            torch.testing.assert_close(g_card[k], v, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card[2], cpu[2], rtol=1e-4, atol=1e-4)


def test_gspmd_step_on_the_card_matches_the_cpu(cuda):
    """``FullBatchTrainer(mesh=4, dist_impl="gspmd")``: two steps and an
    evaluation with fixed noise; losses and scores on the card against the
    CPU within 1e-4·(1 + |CPU|); K1 = K2 = 0 (the all-gather layout)."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    ds = synthetic_gad(n_nodes=900, avg_degree=10, feat_dim=24,
                       n_communities=3, seed=4)
    res = {}
    for device in (cuda, "cpu"):
        tr = FullBatchTrainer(ds, embedding_dim=48, mesh=4,
                              dist_impl="gspmd", noise_mean=0.02,
                              noise_std=0.0, device=device)
        assert tr.route == "coo"
        tr.model.load_state_dict(tr.init())
        gen = torch.Generator(tr.device).manual_seed(0)
        before = _launches()
        losses = [[float(x) for x in tr.train_step(gen)] for _ in range(2)]
        scores = tr.eval_scores()
        assert _launches() == before
        res[str(device)] = (np.array(losses), scores)
    card, cpu = res[str(cuda)], res["cpu"]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-4, atol=1e-4)


def test_tp_2d_step_on_the_card_matches_the_cpu(cuda):
    """``sharded_train_step_2d`` on a (2, 2) ``('nodes', 'model')`` mesh,
    2 steps from the seeded init with fixed noise: the loss on the card
    against the CPU and against the 1-D step within 1e-4 relative."""
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad
    from ggad_tpu_torch.parallel.full_batch import (
        sharded_train_step,
        sharded_train_step_2d,
    )
    from ggad_tpu_torch.parallel.mesh import make_mesh

    ds = synthetic_gad(n_nodes=900, avg_degree=10, feat_dim=24, seed=4)
    noises = [torch.randn(len(ds.abnormal_label_idx), 48,
                          generator=torch.Generator().manual_seed(i))
              for i in range(2)]
    got = {}
    for device in (cuda, "cpu"):
        mesh = make_mesh(4, device=device, axis_names=("nodes", "model"),
                         shape=(2, 2))
        got[str(device)] = sharded_train_step_2d(mesh, ds, n_h=48,
                                                 n_steps=2, noises=noises)
    one_d = sharded_train_step(4, ds, n_h=48, n_steps=2, noises=noises,
                               device=cuda)
    assert got[str(cuda)] == pytest.approx(got["cpu"], rel=1e-4)
    assert got[str(cuda)] == pytest.approx(one_d, rel=1e-4)
