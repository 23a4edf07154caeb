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
gradients and train-step losses on the card against the CPU 1e-4.
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
