"""The compressed rows of a tile store's non-zeros (``BCSR.row_ptr``,
``col``, ``val``), which the port's CUDA kernels walk, against the tile
store itself and against ``ggad_tpu``'s tile store.

For square, transposed and rectangular sets (cover tiles, ``n_tiles_pad``),
f32 and bf16, tile heights 128/256/1024 and an empty tile row, the
compressed rows densify back to the tile store exactly and hold exactly
the non-zeros of the JAX package's store, in rows whose columns ascend.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggad_tpu.graph as jg
import ggad_tpu.ops.pallas_spmm as jp
import ggad_tpu_torch.graph as pg
from ggad_tpu_torch.ops import bcsr_spmm as pb

JAX_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16}


def dense_of_tiles(tile_rows, tile_cols, values, n_rows, n_cols):
    """The matrix a tile store holds, in f32 (tiles sum where keys repeat:
    padding tiles repeat the last key with zeros)."""
    values = np.asarray(values).astype(np.float32)
    tr = values.shape[1]
    dense = np.zeros((n_rows, n_cols), np.float32)
    for t, (r, c) in enumerate(zip(np.asarray(tile_rows).tolist(),
                                   np.asarray(tile_cols).tolist())):
        dense[r * tr:(r + 1) * tr, c * 128:(c + 1) * 128] += values[t]
    return dense


def dense_of_csr(tiles):
    ptr = tiles.row_ptr.numpy()
    rows = np.repeat(np.arange(tiles.n_rows), np.diff(ptr))
    dense = np.zeros((tiles.n_rows, tiles.n_cols), np.float32)
    dense[rows, tiles.col.numpy()] = tiles.val.float().numpy()
    return dense


def graph(n, seed, *, empty_rows=True):
    """A random graph with duplicate entries; with ``empty_rows`` no edge
    lands in rows 128..255 (an empty tile row at heights 128 and 256)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 12 * n)
    if empty_rows:
        rows = rows[(rows < 128) | (rows >= 256)]
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.uniform(0.25, 1.5, rows.shape[0]).astype(np.float32)
    return rows, cols, vals


def tile_sets(kind, dtype, tr):
    """(port BCSR, JAX BCSR) of one kind of tile set."""
    n = 300
    rows, cols, vals = graph(n, tr)
    if kind in ("square", "transposed"):
        p = pb.bcsr_pair_from_graph(pg.from_coo(rows, cols, vals, n,
                                                device="cpu"), dtype,
                                    tile_rows=tr)
        j = jp.bcsr_pair_from_graph(jg.from_coo(rows, cols, vals, n),
                                    JAX_DTYPE[dtype], tile_rows=tr)
        return (p.fwd, j.fwd) if kind == "square" else (p.bwd, j.bwd)
    # rectangular: [300 × 150], rows 128..255 covered by zero tiles; "pad"
    # adds padding tiles that repeat the last key
    keep = cols < 150
    args = (rows[keep], cols[keep], vals[keep], n, 150,
            40 if kind == "rect_pad" else 0)
    p = pb.bcsr_rect_from_coo(*args, dtype=dtype, tile_rows=tr,
                              device="cpu")
    j = jp.bcsr_rect_from_coo(*args, dtype=JAX_DTYPE[dtype], tile_rows=tr)
    return p, j


@pytest.mark.parametrize("tr", [128, 256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["square", "transposed", "rect",
                                  "rect_pad"])
def test_csr_holds_the_stores_non_zeros(kind, dtype, tr):
    p, j = tile_sets(kind, dtype, tr)
    ptr = p.row_ptr.numpy()
    assert p.row_ptr.dtype == p.col.dtype == torch.int32
    assert p.val.dtype == p.values.dtype
    assert ptr.shape == (p.n_rows + 1,) and ptr[0] == 0
    assert ptr[-1] == p.col.numel() == p.val.numel()
    assert np.all(np.diff(ptr) >= 0)
    # the columns ascend within every row
    col = p.col.numpy().astype(np.int64)
    rows = np.repeat(np.arange(p.n_rows), np.diff(ptr))
    assert np.all((rows[1:] > rows[:-1]) | (col[1:] > col[:-1]))
    assert np.all(p.val.float().numpy() != 0)
    # back to the tile store exactly, and equal to the JAX store's entries
    dense = dense_of_csr(p)
    np.testing.assert_array_equal(dense, dense_of_tiles(
        p.tile_rows, p.tile_cols, p.values.float(), p.n_rows, p.n_cols))
    np.testing.assert_array_equal(dense, dense_of_tiles(
        j.tile_rows, j.tile_cols, j.values, j.n_rows, j.n_cols))
    if kind != "transposed" and tr < 1024:
        assert ptr[128] == ptr[256]          # the empty tile row


def test_csr_of_an_empty_store_and_with_dtype():
    """No edge at all: every row empty. ``with_dtype`` derives the rows
    anew from the cast values, and keeps the store it is given when the
    dtype does not change."""
    p = pb.bcsr_from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros(0, np.float32), 200, device="cpu")
    assert p.n_tiles == 0 and p.col.numel() == 0
    assert p.row_ptr.tolist() == [0] * (p.n_rows + 1)

    rows, cols, vals = graph(300, 5)
    f = pb.bcsr_from_coo(rows, cols, vals, 300, tile_rows=256,
                         device="cpu")
    assert f.with_dtype("float32") is f
    b = f.with_dtype("bfloat16")
    assert b.val.dtype == torch.bfloat16
    assert torch.equal(b.row_ptr, f.row_ptr) and torch.equal(b.col, f.col)
    assert torch.equal(b.val, f.val.to(torch.bfloat16))


@pytest.mark.parametrize("dtype,d,ld", [
    (torch.float32, 300, 300), (torch.float32, 33, 36),
    (torch.bfloat16, 300, 304), (torch.bfloat16, 48, 48),
    (torch.bfloat16, 20, 24)])
def test_vector_rows(dtype, d, ld):
    """The operand layout the kernels read: the store's dtype, rows a
    whole number of 16-byte vectors; an operand that already is so is
    passed through, one that starts off a 16-byte boundary is copied."""
    x = torch.randn(7, d, generator=torch.Generator().manual_seed(d))
    y = pb.vector_rows(x, dtype)
    assert y.dtype == dtype and y.shape == (7, ld) and y.is_contiguous()
    assert y.data_ptr() % 16 == 0
    assert torch.equal(y[:, :d], x.to(dtype))
    if dtype == torch.float32 and ld == d:
        assert y is x
    off = torch.zeros(7 * d + 1)[1:].view(7, d)       # 4 bytes off
    off.copy_(x)
    z = pb.vector_rows(off, dtype)
    assert z.data_ptr() % 16 == 0 and torch.equal(z[:, :d], x.to(dtype))
