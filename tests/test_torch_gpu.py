"""The port's CUDA kernel against its plain version on the card.

Marked ``gpu``: each test decides inside its body whether a card is
present and skips without one. On a machine with an H100 run
``python -m pytest tests/test_torch_gpu.py -q``. Tolerances as in
``test_torch_bcsr_spmm.py``: f32 1e-5, bf16 2e-5 rel/abs (only the f32
summation order differs).
"""

import numpy as np
import pytest
import torch

import ggad_tpu_torch.graph as pg
from ggad_tpu_torch.ops import bcsr_spmm as pb

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-5)])
@pytest.mark.parametrize("n,d,tr,empty_row", [
    (300, 40, 128, True), (700, 300, 256, False), (2100, 72, 1024, False)])
def test_kernel_matches_plain(cuda, dtype, tol, n, d, tr, empty_row):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, n, 20 * n)
    if empty_row:       # no edge lands in rows 128..255: an empty tile row
        rows = rows[(rows < 128) | (rows >= 256)]
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.random(rows.shape[0]).astype(np.float32)
    g = pg.from_coo(rows, cols, vals, n, device=cuda)
    tiles = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=tr).tiles
    h = torch.randn(n, d, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    before = pb.bcsr_spmm.launches
    out = pb.bcsr_spmm(tiles, h)
    torch.cuda.synchronize()
    assert pb.bcsr_spmm.launches == before + 1
    expect = pb.bcsr_spmm_plain(tiles, h)
    torch.testing.assert_close(out, expect, rtol=tol, atol=tol)
    if empty_row:
        assert torch.all(out[128:256] == 0)
