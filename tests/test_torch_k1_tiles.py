"""The staged route of K1: the tile-local view (``ops.bcsr_spmm.TileView``)
and the kernel's schedule over it, on the CPU.

``staged_schedule`` below walks the view exactly as
``csrc/bcsr_spmm.cu``'s staged kernel does: a block per band of a tile
row, the band's stages in order, each with its tile's slab of H (rows past
H's count read as zero) and its entry block; each consumer warp reads its
offset and its 8 slots' run lengths from the block's header, then each
slot's non-zeros in column order, one multiply-add each into the slot's
accumulator; each slot is written to its band-local row. It is held
against the plain version and against ``ggad_tpu``'s Pallas kernel in
interpret mode (as ``tests/test_pallas_spmm.py`` runs it). Tolerances:
f32 1e-5 rel/abs, bf16 2e-5, as ``test_torch_bcsr_spmm.py``: the sums run
in ascending column order here and in tile order there, and bf16 products
are exact in f32.

The view's invariants: every stored non-zero exactly once, with its value's
bits; blocks that fit and are 16-byte aligned; a band's stages in tile
order; each slot's columns ascending and < 128; each band's slots a
permutation of its rows; warps balanced by non-zeros.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggad_tpu.ops.pallas_spmm as jp
import ggad_tpu_torch.graph as pg
from ggad_tpu_torch.ops import bcsr_spmm as pb

TOL = {"float32": 1e-5, "bfloat16": 2e-5}
SENTINEL = 0xFFFFFFFF


def graph(n, seed, *, per_row=12, empty_rows=False, heavy_row=None):
    """Random entries (duplicates included); ``empty_rows``: none in rows
    128..255; ``heavy_row``: that row holds every column, with values
    scaled by 1/n as a normalized adjacency's are (so its sum of n terms
    stays O(1), and two summation orders agree to the tolerance)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, per_row * n)
    if empty_rows:
        rows = rows[(rows < 128) | (rows >= 256)]
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.uniform(0.25, 1.5, rows.shape[0]).astype(np.float32)
    if heavy_row is not None:
        rows = np.r_[rows, np.full(n, heavy_row)]
        cols = np.r_[cols, np.arange(n)]
        vals = np.r_[vals, rng.uniform(0.25, 1.5, n).astype(np.float32) / n]
    return rows, cols, vals


def store(kind, dtype, tr, n=600, seed=0, **kw):
    """(tile store, rows of H, output rows) of one kind of set."""
    rows, cols, vals = graph(n, seed, **kw)
    if kind in ("square", "transposed"):
        pair = pb.bcsr_pair_from_graph(
            pg.from_coo(rows, cols, vals, n, device="cpu"), dtype,
            tile_rows=tr)
        return (pair.fwd if kind == "square" else pair.bwd), n, n
    if kind == "subset":                 # [U × N]: the labeled rows
        keep = rows % 5 == 0
        u_of = {r: i for i, r in enumerate(np.unique(rows[keep]))}
        ru = np.array([u_of[r] for r in rows[keep]], np.int64)
        tiles = pb.bcsr_rect_from_coo(ru, cols[keep], vals[keep], len(u_of),
                                      n, dtype=dtype, tile_rows=tr,
                                      device="cpu")
        return tiles, n, len(u_of)
    # remote [R × W]: W buffer columns, H holds only W - 70 rows, so the
    # entries in the last 70 columns read zeros (columns past h_rows)
    r_rows, w = n // 2, n
    keep = rows < r_rows
    tiles = pb.bcsr_rect_from_coo(rows[keep], cols[keep], vals[keep],
                                  r_rows, w, n_tiles_pad=0, dtype=dtype,
                                  tile_rows=tr, device="cpu")
    return tiles, w - 70, r_rows


def stage_blocks(view, item):
    """Each stage as (tile column, {warp: [[(column, value bits), ...] a
    slot]}), read from ``blocks`` through the header, as the kernel reads
    them: the warp's entry offset, its ``WARP_ROWS`` run lengths (a byte
    each), then
    that many entries a slot."""
    blocks = view.blocks.numpy()
    out = []
    for col, word, words, _ in view.stages.numpy():
        blk = blocks[word:word + words]
        ent = blk[view.header_words:].reshape(-1, 2)
        segs = {}
        for w in range(view.warps):
            k = blk[w]
            nw = pb.WARP_ROWS // 4
            runs = blk[view.warps + nw * w:view.warps + nw * (w + 1)].view(
                np.uint8)                      # little-endian: slot order
            slots = []
            row = pb.STAGED_CHUNK * item       # bytes of a slab row
            for n in runs:
                off, bits = ent[k:k + n, 0], ent[k:k + n, 1]
                assert np.all(off % row == 0)
                slots.append(list(zip((off // row).tolist(), bits)))
                k += n
            segs[w] = slots
        out.append((int(col), segs))
    return out


def staged_schedule(tiles, view, h, n_out):
    """The staged kernel's schedule over ``view`` (see the module doc),
    each multiply-add rounded to f32 once, as an FMA is."""
    n, d = h.shape
    band, warps = view.band, view.warps
    hp = torch.zeros(tiles.n_cols, d)
    hp[:n] = h
    if tiles.values.dtype == torch.bfloat16:
        hp = hp.to(torch.bfloat16).float()
    hp = hp.numpy()
    ptr, slot_rows = view.stage_ptr.numpy(), view.slot_rows.numpy()
    stages = stage_blocks(view, tiles.values.element_size())
    out = np.full((n_out, d), np.nan, np.float32)
    for g in range(-(-n_out // band)):
        acc = np.zeros((warps, pb.WARP_ROWS, d), np.float32)
        for col, segs in stages[ptr[g]:ptr[g + 1]]:
            slab = hp[col * 128:(col + 1) * 128]
            for w in range(warps):
                for j, run in enumerate(segs[w]):
                    for c, bits in run:
                        v = np.float64(np.int32(bits).view(np.float32))
                        x = slab[c].astype(np.float64)
                        acc[w, j] = (acc[w, j] + v * x).astype(np.float32)
        for w in range(warps):
            for j in range(pb.WARP_ROWS):
                r = g * band + slot_rows[(g * warps + w) * pb.WARP_ROWS + j]
                if r < n_out:
                    out[r] = acc[w, j]
    return out


def walk_schedule(tiles, h, n_out):
    """The walk's schedule over the compressed rows, on the CPU: a row of
    at most ``heavy_min`` non-zeros is one chain of multiply-adds in column
    order; a heavy row is eight chains over its eighths, added in order
    (the kernel's heavy block). Each multiply-add rounded to f32 once."""
    heavy_min, _ = tiles.heavy
    n, d = h.shape
    hp = torch.zeros(tiles.n_cols, d)
    hp[:n] = h
    if tiles.values.dtype == torch.bfloat16:
        hp = hp.to(torch.bfloat16).float()
    hp = hp.numpy().astype(np.float64)
    ptr, col = tiles.row_ptr.numpy(), tiles.col.numpy()
    val = tiles.val.float().numpy().astype(np.float64)
    out = np.zeros((n_out, d), np.float32)
    for r in range(n_out):
        b, e = int(ptr[r]), int(ptr[r + 1])
        cuts = ([b, e] if e - b <= heavy_min
                else [b + (e - b) * w // 8 for w in range(9)])
        total = None
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            acc = np.zeros(d, np.float32)
            for k in range(lo, hi):
                acc = (acc + val[k] * hp[col[k]]).astype(np.float32)
            total = acc if total is None else (total + acc).astype(
                np.float32)
        out[r] = total
    return out


def jax_product(tiles, h, n_out):
    """``ggad_tpu``'s Pallas K1 on the same tile arrays (interpret mode)."""
    m = jp.BCSR(tile_rows=jnp.asarray(tiles.tile_rows.numpy()),
                tile_cols=jnp.asarray(tiles.tile_cols.numpy()),
                values=jnp.asarray(tiles.values.float().numpy()).astype(
                    jnp.bfloat16 if tiles.values.dtype == torch.bfloat16
                    else jnp.float32),
                n_rows=tiles.n_rows, n_cols=tiles.n_cols)
    d = h.shape[1]
    d_tile = jp._pick_d_tile(d)
    hp = jp._pad_h(jnp.asarray(h.numpy()), tiles.n_cols, d_tile)
    return np.asarray(jp._bcsr_matmul_raw(m, hp, d_tile))[:n_out, :d]


def dense_of_view(tiles, view):
    """The matrix the view holds, from its stages alone; and how often
    each element appears."""
    band, warps = view.band, view.warps
    ptr, slot_rows = view.stage_ptr.numpy(), view.slot_rows.numpy()
    stages = stage_blocks(view, tiles.values.element_size())
    dense = np.zeros((tiles.n_rows, tiles.n_cols), np.float32)
    seen = np.zeros_like(dense, dtype=np.int64)
    for g in range(len(ptr) - 1):
        for col, segs in stages[ptr[g]:ptr[g + 1]]:
            for w, slots in segs.items():
                for slot, run in enumerate(slots):
                    r = g * band + slot_rows[(g * warps + w) * pb.WARP_ROWS
                                             + slot]
                    for c, bits in run:
                        assert c < 128
                        dense[r, col * 128 + c] += np.int32(bits).view(
                            np.float32)
                        seen[r, col * 128 + c] += 1
    return dense, seen


def dense_of_tiles(tiles):
    tr = tiles.tile_height
    dense = np.zeros((tiles.n_rows, tiles.n_cols), np.float32)
    for t, (r, c) in enumerate(zip(tiles.tile_rows.tolist(),
                                   tiles.tile_cols.tolist())):
        dense[r * tr:(r + 1) * tr, c * 128:(c + 1) * 128] += (
            tiles.values[t].float().numpy())
    return dense


@pytest.mark.parametrize("tr", [128, 256, 512, 1024])
@pytest.mark.parametrize("kind", ["square", "transposed", "subset",
                                  "remote"])
def test_view_holds_every_non_zero_once(kind, tr):
    tiles, _, _ = store(kind, "bfloat16" if tr == 512 else "float32", tr,
                        empty_rows=kind == "square")
    for view in (pb.tile_view(tiles),):
        band = view.band
        dense, seen = dense_of_view(tiles, view)
        expect = dense_of_tiles(tiles)
        assert np.array_equal(seen, (expect != 0).astype(np.int64))
        np.testing.assert_array_equal(dense, expect)     # the value's bits
        # blocks fit, are 16-byte aligned, and hold each warp's segment in
        # (slot, column) order; a band's stages follow its tiles' order
        st = view.stages.numpy()
        assert np.all(st[:, 2] <= pb.STAGED_BLOCK_WORDS)
        assert np.all(st[:, 1] % 4 == 0) and np.all(st[:, 2] % 4 == 0)
        assert np.array_equal(st[1:, 1], (st[:, 1] + st[:, 2])[:-1])
        for _, segs in stage_blocks(view, tiles.values.element_size()):
            for slots in segs.values():
                for run in slots:                    # columns ascend
                    assert np.all(np.diff([c for c, _ in run]) > 0)
        ptr = view.stage_ptr.numpy()
        assert ptr[0] == 0 and np.all(np.diff(ptr) >= 0)
        for g in range(len(ptr) - 1):
            cols = st[ptr[g]:ptr[g + 1], 0]
            assert np.all(np.diff(cols) >= 0)        # tiles in column order
        # each band's slots are its rows, once each
        n_bands = tiles.n_rows // band
        slots = view.slot_rows.numpy().reshape(n_bands, band)
        assert np.array_equal(np.sort(slots, axis=1),
                              np.broadcast_to(np.arange(band), slots.shape))


def test_warps_share_a_band_by_non_zeros():
    """Rows are dealt to warps by their non-zero count over the band: no
    two warps differ by more than the heaviest row, even with a row that
    holds every column."""
    tiles, _, _ = store("square", "float32", 1024, n=1024, heavy_row=700)
    view = pb.tile_view(tiles)
    counts = np.bincount(np.repeat(np.arange(tiles.n_rows),
                                   np.diff(tiles.row_ptr.numpy())),
                         minlength=tiles.n_rows).reshape(-1, view.band)
    slots = view.slot_rows.numpy().reshape(-1, view.warps, pb.WARP_ROWS)
    for g in range(counts.shape[0]):
        per_warp = counts[g][slots[g]].sum(axis=1)
        assert per_warp.max() - per_warp.min() <= counts[g].max()
    assert counts.max() >= 1024                  # the heavy row is there


CASES = [
    # kind, dtype, tile height, d, graph options
    ("square", "float32", 128, 25, dict(empty_rows=True)),
    ("square", "bfloat16", 256, 300, dict(empty_rows=True)),
    ("square", "float32", 1024, 745, dict(heavy_row=333)),
    ("transposed", "float32", 512, 1, dict(heavy_row=5)),
    ("transposed", "bfloat16", 1024, 25, {}),
    ("subset", "float32", 256, 300, {}),
    ("subset", "bfloat16", 128, 1, {}),
    ("remote", "float32", 1024, 300, {}),
    ("remote", "bfloat16", 512, 745, {}),
    # tiles dense enough that a band-tile fills several entry blocks
    ("square", "float32", 256, 33, dict(per_row=150)),
]


@pytest.mark.parametrize("kind,dtype,tr,d,opts", CASES)
def test_staged_schedule_matches_plain_and_pallas(kind, dtype, tr, d, opts):
    tiles, n_h, n_out = store(kind, dtype, tr, seed=tr + d, **opts)
    h = torch.from_numpy(np.random.default_rng(d).normal(
        size=(n_h, d)).astype(np.float32))
    plain = pb.bcsr_spmm_plain(tiles, h, n_out).numpy()
    # the Pallas kernel leaves the rows of a tile row with no tiles unset
    occupied = np.diff(tiles.tile_ptr.numpy()) > 0
    live = np.repeat(occupied, tr)[:n_out]
    ref = jax_product(tiles, h, n_out)[live]
    np.testing.assert_allclose(plain[live], ref, rtol=TOL[dtype],
                               atol=TOL[dtype])
    out = staged_schedule(tiles, pb.tile_view(tiles), h, n_out)
    np.testing.assert_allclose(out, plain, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(out[live], ref, rtol=TOL[dtype],
                               atol=TOL[dtype])
    if opts.get("empty_rows"):
        assert np.all(out[128:256] == 0)


@pytest.mark.parametrize("kind,dtype,tr,d,opts", CASES)
def test_walk_schedule_matches_plain_and_pallas(kind, dtype, tr, d, opts):
    """The walk, with its heavy rows (a row that holds every column) taken
    apart into eighths, against the plain version and the Pallas kernel."""
    tiles, n_h, n_out = store(kind, dtype, tr, seed=tr + d, **opts)
    h = torch.from_numpy(np.random.default_rng(d).normal(
        size=(n_h, d)).astype(np.float32))
    plain = pb.bcsr_spmm_plain(tiles, h, n_out).numpy()
    out = walk_schedule(tiles, h, n_out)
    np.testing.assert_allclose(out, plain, rtol=TOL[dtype], atol=TOL[dtype])
    occupied = np.diff(tiles.tile_ptr.numpy()) > 0
    live = np.repeat(occupied, tr)[:n_out]
    np.testing.assert_allclose(out[live], jax_product(tiles, h, n_out)[live],
                               rtol=TOL[dtype], atol=TOL[dtype])
    if kind == "square" and opts.get("heavy_row") is not None:
        assert opts["heavy_row"] in tiles.heavy[1].tolist()


def test_walk_heavy_rows_are_the_long_rows():
    """A row of more than ``HEAVY_OVER_MEAN`` times the mean non-empty row
    (and more than ``HEAVY_MIN``) is heavy, and every such row is listed:
    the kernel writes a heavy row only from its block."""
    tiles, _, _ = store("square", "float32", 256, n=600, heavy_row=7)
    heavy_min, rows = tiles.heavy
    lens = np.diff(tiles.row_ptr.numpy())
    assert heavy_min == max(pb.HEAVY_MIN, int(pb.HEAVY_OVER_MEAN
                                              * lens[lens > 0].mean()))
    assert rows.dtype == torch.int32
    assert rows.tolist() == np.flatnonzero(lens > heavy_min).tolist() == [7]
    flat, _, _ = store("square", "float32", 256, n=600)
    assert flat.heavy[1].numel() == 0 and flat.heavy[0] == pb.HEAVY_MIN
    # a copy with other values derives its heavy rows anew
    v = tiles.values.clone()
    v[tiles.tile_rows == 0, 7] = 0
    assert dataclasses.replace(tiles, values=v).heavy[1].numel() == 0


def test_route_follows_the_tiles_density():
    """Tiles whose slab rows a band reads ``STAGED_MIN_REUSE`` times or
    more take the staged route, sparser tiles the walk; a store on the
    CPU carries no view (it never launches the kernel)."""
    dense, _, _ = store("square", "float32", 1024, n=800, per_row=300)
    assert pb.slab_reuse(dense) >= pb.STAGED_MIN_REUSE
    assert dense.route == "staged" and dense.view is None
    view = pb.tile_view(dense)
    assert view.band == pb.BAND
    # its band-tiles overflow a block: each is cut into pieces, all of
    # which stage the tile's slab
    assert view.stages.shape[0] > dense.n_tiles * 8
    sparse, _, _ = store("square", "float32", 1024, n=600, per_row=12)
    assert pb.slab_reuse(sparse) < pb.STAGED_MIN_REUSE
    assert sparse.route == "walk" and sparse.view is None
    assert pb.k1_launch_shape(sparse, 64, 600) == {"route": "walk"}
    # a band's stages once a column chunk; the launch's own shape (blocks,
    # threads, shared memory) comes from the kernel, for a store on the card
    shape = pb.k1_launch_shape(dense, 300, 800, view)
    chunks = -(-300 // pb.STAGED_CHUNK)
    assert shape["stages"] == int(view.stage_ptr[-(-800 // pb.BAND)]) * chunks
    assert shape["slab_mb"] == shape["stages"] * 128 * pb.STAGED_CHUNK * 4 / 1e6
    assert "blocks" not in shape


def test_a_view_that_does_not_fit_the_store_is_refused():
    tiles, _, _ = store("square", "float32", 256, n=300)
    view = pb.tile_view(tiles)
    other, _, _ = store("square", "float32", 256, n=700)
    with pytest.raises(ValueError, match="stage_ptr"):
        pb.check_view(other, view)
    with pytest.raises(ValueError, match="fit"):
        pb.check_view(tiles, dataclasses.replace(view, band=512))
