"""Block-sparse (BCSR) SpMM — counterpart of ``ggad_tpu/ops/pallas_spmm.py``.

The adjacency is stored as its occupied tiles (tile-COO, sorted by
(tile_row, tile_col)); tile t is a ``[tr, 128]`` block at rows
``tile_rows[t]·tr`` and columns ``tile_cols[t]·128``, and

    out[tile_row block] += A_t @ H[tile_col block]

Beside the tile store every :class:`BCSR` holds the compressed rows of its
stored non-zeros (``row_ptr``, ``col``, ``val``) and, on the card where
its tiles are dense enough to pay for staging, a tile-local view of the
same non-zeros (:class:`TileView`), both derived from the stored values
when the tiles are built. For CUDA tensors the hand-written kernel
``csrc/bcsr_spmm.cu`` (K1's port) takes one of two routes, fixed by the
store's shape when it is built (:func:`k1_route`): the staged route
copies each tile's slab of H into shared memory and reads it there for
the tile's non-zeros; the walk reads one row of H from L2 for each
non-zero. :func:`bcsr_spmm_plain`, a loop over tiles with the kernel's
arithmetic, computes the product for CPU tensors.

A graph carries a :class:`BCSRPair`: the forward tile set and, for
training, the tile set of the transpose (serving builds only the forward
set). :func:`bcsr_spmm` is differentiable in H; its backward is K1 again,
on the transposed set. The adjacency is not trained and gets no
gradient. Rectangular tile sets (:func:`bcsr_rect_from_coo`) feed the
SDDMM's backward, where the product's output rows differ from H's rows.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ggad_tpu_torch import native
from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.ops import _build
from ggad_tpu_torch.utils.tracing import span

TILE = 128  # tile width (and the unit of tile heights)

# The staged route (csrc/bcsr_spmm.cu, namespace staged). A block
# accumulates a band of BAND rows of one tile row over STAGED_CHUNK
# columns; each of its BAND // WARP_ROWS consumer warps holds WARP_ROWS of
# those rows, two columns a lane. The views are built for these values; on
# the card they are held against the kernel's own (check_layout).
WARP_ROWS = 8                  # the kernel's kSlots
BAND = 128                     # rows a block accumulates (kWarps · kSlots)
STAGED_MIN_REUSE = 3.0         # below this the walk (k1_route)
STAGED_CHUNK = 64              # columns of H a block covers (kChunk)
STAGED_STAGES = 3              # stages in flight (kStages)
STAGED_BLOCK_WORDS = 4096      # words of a stage's entry block (kBlockWords)
# The walk: a row of more than max(HEAVY_MIN, HEAVY_OVER_MEAN × the mean
# non-empty row) non-zeros gets a block of its own (heavy_rows).
HEAVY_MIN = 64
HEAVY_OVER_MEAN = 2.0

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def storage_dtype(dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (the trainer's ``spmm_dtype``) or a
    torch dtype → the torch dtype of a tile store or ELL table."""
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sparse values are float32 or bfloat16, not "
                         f"{dtype}")
    return dtype


def tile_csr(tile_rows: torch.Tensor, tile_cols: torch.Tensor,
             values: torch.Tensor, n_rows: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compressed rows of a tile store's non-zeros, on its device:
    ``row_ptr [n_rows + 1]`` int32, ``col [nnz]`` int32 (global columns)
    and ``val [nnz]`` in the store's dtype. The order is ``nonzero()`` over
    ``[T, tr, 128]`` stably sorted by global row, so each row's columns
    ascend (the order in which the tile loop adds them) and the values are
    exactly the stored ones."""
    tr = values.shape[1]
    t, r, c = torch.nonzero(values, as_tuple=True)
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{t.numel()} non-zeros do not fit int32 indices")
    grow = tile_rows.long()[t] * tr + r
    grow, order = torch.sort(grow, stable=True)
    t, r, c = t[order], r[order], c[order]
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=values.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(grow, minlength=n_rows), 0)
    col = (tile_cols.long()[t] * TILE + c).to(torch.int32)
    return row_ptr, col, values[t, r, c]


def heavy_rows(row_ptr: torch.Tensor) -> tuple[int, torch.Tensor]:
    """The walk's heavy rows of compressed rows: ``(heavy_min, rows)``, the
    rows (int32, ascending, on ``row_ptr``'s device) of more than
    ``heavy_min`` non-zeros, where ``heavy_min`` is ``HEAVY_OVER_MEAN``
    times the mean non-empty row, and at least ``HEAVY_MIN``. The kernel
    walks each such row with a block of warps and every other row with one
    warp, so the list must hold every row over ``heavy_min``."""
    lens = row_ptr[1:] - row_ptr[:-1]
    busy = lens[lens > 0]
    mean = float(busy.float().mean()) if busy.numel() else 0.0
    heavy_min = max(HEAVY_MIN, int(HEAVY_OVER_MEAN * mean))
    rows = torch.nonzero(lens > heavy_min).flatten().to(torch.int32)
    return heavy_min, rows


@dataclasses.dataclass(frozen=True)
class TileView:
    """The non-zeros of a tile store as the staged route of K1 reads them.

    A *band* is ``BAND`` consecutive rows of one tile row; the kernel gives
    each band one block a chunk of ``STAGED_CHUNK`` columns of H, whose
    ``BAND // WARP_ROWS`` consumer warps hold ``WARP_ROWS`` rows each, two
    columns a lane. Within a band, rows go to (warp, slot) by their
    non-zero count over the band (heaviest first, dealt to the warps back
    and forth), so each warp gets an equal share of the band's non-zeros.
    ``slot_rows[(g·warps + w)·WARP_ROWS + j]`` is the band-local row of
    slot j of warp w in band g.

    A band reads its tile row's tiles in order, one *stage* each (a tile
    with none of the band's non-zeros has none; one with more than a
    stage's block holds is split into consecutive pieces, each staging the
    same slab of H). ``stages[stage_ptr[g] .. stage_ptr[g+1]]`` are band
    g's, each ``(tile column, word offset, words, 0)``: where its *block*
    lies in ``blocks`` (int32 words, 16-byte aligned), which the kernel
    copies into shared memory beside the slab. A block is a header, the
    warps' entry offsets and then each warp's ``WARP_ROWS`` run lengths (a
    byte each), followed by each warp's *segment*: its non-zeros of the
    stage, ordered by (slot, column), each an entry ``(column ·
    STAGED_CHUNK · item, value)`` (the byte offset of the column's row in
    the slab, and the value as f32 bits, a bf16 value widened exactly).
    Each non-zero of the store is in exactly one segment.
    """

    band: int
    stage_ptr: torch.Tensor  # [n_rows // band + 1] int32
    stages: torch.Tensor     # [S, 4] int32
    blocks: torch.Tensor     # [words] int32
    slot_rows: torch.Tensor  # [n_rows // band · warps · WARP_ROWS] int32
    reuse: float             # non-zeros a staged slab row, on average

    @property
    def warps(self) -> int:
        return self.band // WARP_ROWS

    @property
    def header_words(self) -> int:
        return header_words(self.warps)


def header_words(warps: int) -> int:
    """Words of a block's header: an entry offset and ``WARP_ROWS / 4``
    words of run lengths a warp (a multiple of 4: 16 bytes)."""
    return warps * (1 + WARP_ROWS // 4)


def slab_reuse(tiles) -> float:
    """How often, on average, each staged slab row (a row of H under one
    tile) is read when every band of a tile row stages every tile of the
    row: the store's non-zeros over ``T · (tr / BAND) · 128`` slab rows.
    Cover and padding tiles count."""
    t, tr = tiles.values.shape[:2]
    return tiles.col.numel() / max(1, t * (tr // BAND) * TILE)


def k1_route(tiles) -> str:
    """K1's route for a store, fixed by its shape when it is built:
    ``"staged"`` where a staged slab row is read at least
    ``STAGED_MIN_REUSE`` times at ``BAND`` rows a block, else ``"walk"``
    (its tiles hold too few non-zeros a row for a staged slab to pay for
    the slot bookkeeping: ``chip_smoke.py`` times both routes on every K1
    shape of the main paths)."""
    return "staged" if slab_reuse(tiles) >= STAGED_MIN_REUSE else "walk"


_DESCRIBE = ("slots", "band", "chunk", "stages", "block_words",
             "slab_rows", "blocks", "threads", "smem_bytes")
_layout_checked: set = set()


def staged_describe(item: int, n_out: int, d: int) -> dict:
    """The staged kernel's own answer (``csrc/bcsr_spmm.cu``,
    ``bcsr_spmm_staged_describe``) for a store of ``item``-byte values:
    its layout constants and, for an ``[n_out, d]`` output, the blocks,
    threads and dynamic shared memory a block that a launch asks for.
    Builds the library at first use."""
    fn = _build.load("bcsr_spmm").bcsr_spmm_staged_describe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * len(_DESCRIBE))()
    n = fn(item, n_out, d, ctypes.addressof(out), len(_DESCRIBE))
    if n != len(_DESCRIBE):
        raise RuntimeError(f"bcsr_spmm_staged_describe({item}, {n_out}, "
                           f"{d}) returned {n}")
    return dict(zip(_DESCRIBE, out))


def check_layout(item: int) -> None:
    """Raise unless the staged kernel's layout for ``item``-byte values is
    the one :func:`tile_view` builds for (``WARP_ROWS``, ``BAND``,
    ``STAGED_CHUNK``, ``STAGED_STAGES``, ``STAGED_BLOCK_WORDS``, ``TILE``).
    Asks the library once per item size."""
    if item in _layout_checked:
        return
    want = {"slots": WARP_ROWS, "band": BAND, "chunk": STAGED_CHUNK,
            "stages": STAGED_STAGES, "block_words": STAGED_BLOCK_WORDS,
            "slab_rows": TILE}
    got = staged_describe(item, 0, 0)
    got = {k: got[k] for k in want}
    if got != want:
        raise RuntimeError(f"the staged kernel's layout {got} is not the "
                           f"one tile_view builds for, {want}")
    _layout_checked.add(item)


def tile_view(tiles) -> TileView:
    """Build the staged route's view of a tile store on its device (on the
    card, after :func:`check_layout`)."""
    band = BAND
    values = tiles.values
    n_t, tr, _ = values.shape
    dev = values.device
    if dev.type == "cuda":
        check_layout(values.element_size())
    per_tile, warps = tr // band, band // WARP_ROWS
    n_bands = tiles.n_rows // band
    head = header_words(warps)
    t, r, c = torch.nonzero(values, as_tuple=True)
    val = values[t, r, c].float()
    inner = r // band                              # band within the tile
    local = r % band
    g_of_tile = tiles.tile_rows.long() * per_tile
    # rows to (warp, slot): by non-zeros over the band, heaviest first
    # (ties by row), dealt 0 .. warps-1, then back
    count = torch.bincount((g_of_tile[t] + inner) * band + local,
                           minlength=n_bands * band)
    by_rank = torch.sort(-count.view(n_bands, band), dim=1,
                         stable=True).indices           # local row of rank p
    rank = torch.arange(band, device=dev)
    lap, pos = rank // warps, rank % warps
    warp_of = torch.where(lap % 2 == 0, pos, warps - 1 - pos)
    slot_rows = torch.empty(n_bands, warps, WARP_ROWS, dtype=torch.long,
                            device=dev)
    slot_rows[:, warp_of, lap] = by_rank
    row_warp = torch.empty(n_bands, band, dtype=torch.long, device=dev)
    row_slot = torch.empty_like(row_warp)
    row_warp.scatter_(1, by_rank, warp_of.expand(n_bands, band))
    row_slot.scatter_(1, by_rank, lap.expand(n_bands, band))
    g = g_of_tile[t] + inner
    w, s = row_warp[g, local], row_slot[g, local]
    # each (band-tile, warp) segment in (slot, column) order
    bt = t * per_tile + inner
    order = torch.argsort(((bt * warps + w) * WARP_ROWS + s) * TILE + c)
    bt, w, s, c, val = bt[order], w[order], s[order], c[order], val[order]
    n_bt = n_t * per_tile
    seg_len = torch.bincount(bt * warps + w,
                             minlength=n_bt * warps).view(n_bt, warps)
    first = torch.cumsum(seg_len.view(-1), 0) - seg_len.view(-1)
    q = torch.arange(bt.numel(), device=dev) - first[bt * warps + w]
    # pieces: a band-tile whose entries overflow a block is cut into P
    # consecutive pieces, each warp's segment into P runs of at most
    # ceil(len / P); a piece then holds ≤ n / P + warps entries
    room = (STAGED_BLOCK_WORDS - head) // 2 - warps
    total = seg_len.sum(1)
    pieces = torch.where(total > 0, -(-total // room), 0)
    per_piece = -(-seg_len // pieces.clamp(min=1)[:, None])
    p = q // per_piece[bt, w].clamp(min=1)
    # stages in (band, tile, piece) order
    live = torch.nonzero(pieces, as_tuple=True)[0]
    st_bt = torch.repeat_interleave(live, pieces[live])
    st_p = torch.arange(st_bt.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(pieces[live], 0) - pieces[live], pieces[live])
    st_t = st_bt // per_tile
    st_g = g_of_tile[st_t] + st_bt % per_tile
    most = max(1, int(pieces.max())) if n_bt else 1
    st_order = torch.argsort((st_g * n_t + st_t) * most + st_p)
    st_bt, st_p, st_t, st_g = (x[st_order] for x in (st_bt, st_p, st_t,
                                                     st_g))
    n_st = st_bt.numel()
    index = torch.full((n_bt, most), -1, dtype=torch.long, device=dev)
    index[st_bt, st_p] = torch.arange(n_st, device=dev)
    stage = index[bt, p]
    # each stage's per-warp counts, offsets, run lengths and words
    cnt = torch.bincount(stage * warps + w,
                         minlength=n_st * warps).view(n_st, warps)
    off = torch.cumsum(cnt, 1) - cnt
    runs = torch.bincount((stage * warps + w) * WARP_ROWS + s,
                          minlength=n_st * warps * WARP_ROWS)
    words = head + 2 * _round_up_t(cnt.sum(1), 2)
    assert n_st == 0 or int(words.max()) <= STAGED_BLOCK_WORDS
    word_off = torch.cumsum(words, 0) - words
    n_words = int(words.sum())
    if n_words >= 2 ** 31:
        raise ValueError(f"{n_words} words do not fit int32 offsets")
    blocks = torch.zeros(n_words, dtype=torch.int32, device=dev)
    lanes = torch.arange(warps, device=dev)
    blocks[(word_off[:, None] + lanes).view(-1)] = off.view(-1).to(
        torch.int32)
    # run lengths: byte j % 4 of word j // 4 of warp w's words
    n_run_words = WARP_ROWS // 4
    packed = (runs.view(n_st, warps, n_run_words, 4)
              << torch.tensor([0, 8, 16, 24], device=dev)).sum(-1)
    at_runs = (word_off[:, None, None] + warps
               + lanes[:, None] * n_run_words
               + torch.arange(n_run_words, device=dev))
    blocks[at_runs.view(-1)] = packed.view(-1).to(torch.int32)
    rank_in = q - p * per_piece[bt, w]
    at = word_off[stage] + head + 2 * (off[stage, w] + rank_in)
    blocks[at] = (c * STAGED_CHUNK * values.element_size()).to(torch.int32)
    blocks[at + 1] = val.view(torch.int32)
    stages = torch.zeros(n_st, 4, dtype=torch.int32, device=dev)
    stages[:, 0] = tiles.tile_cols[st_t]
    stages[:, 1] = word_off.to(torch.int32)
    stages[:, 2] = words.to(torch.int32)
    stage_ptr = torch.zeros(n_bands + 1, dtype=torch.int32, device=dev)
    stage_ptr[1:] = torch.cumsum(torch.bincount(st_g, minlength=n_bands), 0)
    return TileView(band=band, stage_ptr=stage_ptr, stages=stages,
                    blocks=blocks,
                    slot_rows=slot_rows.view(-1).to(torch.int32),
                    reuse=slab_reuse(tiles))


def _round_up_t(x: torch.Tensor, m: int) -> torch.Tensor:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Tile-COO block-sparse matrix (tiles sorted by (tile_row, tile_col)).

    ``tile_ptr[r] .. tile_ptr[r+1]`` are the tiles of tile row r.
    ``row_ptr``, ``col`` and ``val`` are the stored non-zeros in compressed
    rows (:func:`tile_csr`), built once with the tiles, on their device;
    the walk and K2 read them, and the walk gives the rows in
    ``heavy`` (:func:`heavy_rows`) a block each. ``route`` is K1's route
    for this store
    (:func:`k1_route`); on the staged route a store on the card holds the
    tile-local view it reads in ``view`` (:func:`tile_view`), else None (a
    store on the CPU takes the plain version). A copy with other values
    or on another device (``with_dtype``, ``.to`` through
    ``dataclasses.replace``) derives them anew.
    """

    tile_rows: torch.Tensor  # [T] int32
    tile_cols: torch.Tensor  # [T] int32
    tile_ptr: torch.Tensor   # [n_rows // tr + 1] int32
    values: torch.Tensor     # [T, tr, TILE] float32 or bfloat16
    n_rows: int              # padded to a multiple of tr
    n_cols: int              # padded to a multiple of TILE
    row_ptr: torch.Tensor = dataclasses.field(init=False, repr=False,
                                              compare=False)
    col: torch.Tensor = dataclasses.field(init=False, repr=False,
                                          compare=False)
    val: torch.Tensor = dataclasses.field(init=False, repr=False,
                                          compare=False)
    heavy: tuple = dataclasses.field(init=False, repr=False, compare=False)
    route: str = dataclasses.field(init=False, repr=False, compare=False)
    view: Optional[TileView] = dataclasses.field(init=False, repr=False,
                                                 compare=False)

    def __post_init__(self):
        csr = tile_csr(self.tile_rows, self.tile_cols, self.values,
                       self.n_rows)
        for name, x in zip(("row_ptr", "col", "val"), csr):
            object.__setattr__(self, name, x)
        object.__setattr__(self, "heavy", heavy_rows(self.row_ptr))
        route = k1_route(self)
        object.__setattr__(self, "route", route)
        # only a store on the card launches the kernel
        staged = route == "staged" and self.values.is_cuda
        object.__setattr__(self, "view", tile_view(self) if staged else None)

    @property
    def n_tiles(self) -> int:
        return self.values.shape[0]

    @property
    def tile_height(self) -> int:
        return self.values.shape[1]

    def with_dtype(self, dtype) -> "BCSR":
        dtype = storage_dtype(dtype)
        if self.values.dtype == dtype:
            return self
        return dataclasses.replace(self, values=self.values.to(dtype))


def bcsr_from_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                  n_nodes: int, *, tile_rows: int = TILE,
                  device: DeviceLike = None) -> BCSR:
    """Host-side float32 BCSR build (``pallas_spmm.py:57-95``): duplicate
    edges are summed in input order, by the host library at tile height
    128 (``native.bcsr_build``, as ``pallas_spmm.py:72-75``) and with
    ``np.add.at`` otherwise, which gives the same store. ``tile_rows`` is
    the tile height (a multiple of 128)."""
    if tile_rows <= 0 or tile_rows % TILE:
        raise ValueError(f"tile_rows={tile_rows} is not a multiple of {TILE}")
    device = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    n_row_pad = _round_up(max(n_nodes, tile_rows), tile_rows)
    n_col_pad = _round_up(max(n_nodes, TILE), TILE)
    nct = n_col_pad // TILE
    if tile_rows == TILE and native.available():
        t_rows, t_cols, values = native.bcsr_build(row, col, val, nct)
    else:
        tkey = (row // tile_rows) * nct + col // TILE
        uniq, inv = np.unique(tkey, return_inverse=True)
        values = np.zeros((len(uniq), tile_rows, TILE), np.float32)
        np.add.at(values, (inv, row % tile_rows, col % TILE), val)
        # np.unique returns sorted keys → already (tile_row, tile_col)
        # sorted
        t_rows = (uniq // nct).astype(np.int32)
        t_cols = (uniq % nct).astype(np.int32)
    t_ptr = np.searchsorted(
        t_rows, np.arange(n_row_pad // tile_rows + 1)).astype(np.int32)
    return BCSR(
        tile_rows=torch.from_numpy(t_rows).to(device),
        tile_cols=torch.from_numpy(t_cols).to(device),
        tile_ptr=torch.from_numpy(t_ptr).to(device),
        values=torch.from_numpy(values).to(device),
        n_rows=n_row_pad,
        n_cols=n_col_pad,
    )


def pick_tile_rows(row: np.ndarray, col: np.ndarray, n_nodes: int,
                   *, max_growth: float = 1.35,
                   candidates=(1024, 512, 256)) -> int:
    """The tallest tile height whose tile store stays within
    ``max_growth`` of the 128-tall store (``pallas_spmm.py:368-391``).
    Height changes the schedule, not the math. The candidates and the
    growth limit were measured on the TPU; re-deriving them on the H100
    is open work."""
    nct = _round_up(max(n_nodes, TILE), TILE) // TILE
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)

    def occupied(tr):
        return len(np.unique((row // tr) * nct + col // TILE))

    base = occupied(TILE) * TILE
    for tr in candidates:
        if occupied(tr) * tr <= max_growth * base:
            return tr
    return TILE


@dataclasses.dataclass(frozen=True)
class BCSRPair:
    """Forward and transposed tile sets for the differentiable product
    (``pallas_spmm.py:169-176``). ``bwd`` is None for a forward-only pair
    (``transpose=False``), which takes no gradient."""

    fwd: BCSR
    bwd: Optional[BCSR]
    n_nodes: int


def bcsr_pair_from_graph(g, dtype="float32", tile_rows: int = TILE,
                         transpose: bool = True) -> BCSRPair:
    """Both orientations of ``g`` at one tile height (only the forward one
    unless ``transpose``), built in f32 on ``g``'s device; bf16 tiles are
    that build rounded once, as ``pallas_spmm.py:179-198`` builds them."""
    row, col, val = g.host_coo()
    fwd = bcsr_from_coo(row, col, val, g.n_nodes, tile_rows=tile_rows,
                        device=g.device).with_dtype(dtype)
    bwd = transposed_tiles(g, dtype, tile_rows) if transpose else None
    return BCSRPair(fwd=fwd, bwd=bwd, n_nodes=g.n_nodes)


def transposed_tiles(g, dtype="float32", tile_rows: int = TILE) -> BCSR:
    """The tile set of ``g``'s transpose (the pair's ``bwd``)."""
    row, col, val = g.host_coo()
    return bcsr_from_coo(col, row, val, g.n_nodes, tile_rows=tile_rows,
                         device=g.device).with_dtype(dtype)


def bcsr_rect_from_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                       n_rows: int, n_cols: int, n_tiles_pad: int = 0,
                       dtype="float32", tile_rows: int = TILE,
                       device: DeviceLike = None) -> BCSR:
    """Rectangular ``[n_rows × n_cols]`` tile-COO build, the port of
    ``pallas_spmm.py:284-321``: zero values are dropped, every row block
    gets at least one (zero) cover tile, and ``n_tiles_pad`` pads the tile
    count with zero tiles that repeat the last key. As there, the store is
    built in ``dtype``: each value is rounded to it, and entries on one
    element are added in COO order, rounding after each add
    (``np.add.at`` in the target dtype, ``pallas_spmm.py:311-312``)."""
    device = resolve_device(device)
    dtype = storage_dtype(dtype)
    tr = tile_rows
    rp = _round_up(max(n_rows, tr), tr)
    cp = _round_up(max(n_cols, TILE), TILE)
    nrt, nct = rp // tr, cp // TILE
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    val = np.asarray(val, np.float32)
    live = val != 0
    row, col, val = row[live], col[live], val[live]
    tkey = (row // tr) * nct + col // TILE
    missing = np.setdiff1d(np.arange(nrt, dtype=np.int64),
                           np.unique(row // tr))
    uniq, inv = np.unique(np.concatenate([tkey, missing * nct]),
                          return_inverse=True)
    inv = inv[: len(row)]               # the cover keys carry no values
    n_pad = max(n_tiles_pad, len(uniq))
    flat = (inv * tr + row % tr) * TILE + col % TILE
    values = torch.zeros(n_pad * tr * TILE, dtype=dtype)
    _add_in_order(values, flat, torch.from_numpy(val).to(dtype))
    t_rows = np.full(n_pad, uniq[-1] // nct, np.int32)
    t_cols = np.full(n_pad, uniq[-1] % nct, np.int32)
    t_rows[: len(uniq)] = uniq // nct
    t_cols[: len(uniq)] = uniq % nct
    t_ptr = np.searchsorted(t_rows, np.arange(nrt + 1)).astype(np.int32)
    return BCSR(
        tile_rows=torch.from_numpy(t_rows).to(device),
        tile_cols=torch.from_numpy(t_cols).to(device),
        tile_ptr=torch.from_numpy(t_ptr).to(device),
        values=values.view(n_pad, tr, TILE).to(device),
        n_rows=rp,
        n_cols=cp,
    )


def _add_in_order(store: torch.Tensor, flat: np.ndarray,
                  val: torch.Tensor) -> None:
    """``store[flat[i]] += val[i]`` for i in order, in ``store``'s dtype,
    rounding after each add, as ``np.add.at`` does: the k-th entry on an
    element (in the order given) is added in round k, one add per element
    in a round."""
    if not len(flat):
        return
    order = np.argsort(flat, kind="stable")
    first = np.r_[True, flat[order][1:] != flat[order][:-1]]
    starts = np.maximum.accumulate(np.where(first, np.arange(len(flat)), 0))
    rank = np.arange(len(flat)) - starts
    for k in range(int(rank.max()) + 1):
        sel = torch.from_numpy(order[rank == k])
        idx = torch.from_numpy(flat)[sel]
        store[idx] = store[idx] + val[sel]


@dataclasses.dataclass(frozen=True)
class BCSRGraph:
    """A Graph plus its BCSR tile pair; drop-in for ``ops.spmm``."""

    graph: object            # ggad_tpu_torch.graph.Graph
    tiles: BCSRPair

    @property
    def row(self):
        return self.graph.row

    @property
    def col(self):
        return self.graph.col

    @property
    def val(self):
        return self.graph.val

    @property
    def n_nodes(self):
        return self.graph.n_nodes

    @property
    def n_edges(self):
        return self.graph.n_edges

    @property
    def device(self):
        return self.graph.device

    def in_degrees(self):
        return self.graph.in_degrees()

    def with_transpose(self) -> "BCSRGraph":
        """This graph with the transposed tile set (built now, at the
        forward set's height and dtype, unless it is there)."""
        if self.tiles.bwd is not None:
            return self
        fwd = self.tiles.fwd
        bwd = transposed_tiles(self.graph, fwd.values.dtype, fwd.tile_height)
        return dataclasses.replace(
            self, tiles=dataclasses.replace(self.tiles, bwd=bwd))


def as_bcsr_graph(g, dtype="float32", tile_rows: int | None = None,
                  transpose: bool = True) -> BCSRGraph:
    """Build ``g``'s tile pair on ``g``'s device (forward only unless
    ``transpose``). ``tile_rows=None`` picks the height with
    :func:`pick_tile_rows`."""
    if tile_rows is None:
        row, col, _ = g.host_coo()
        tile_rows = pick_tile_rows(row, col, g.n_nodes)
    return BCSRGraph(graph=g, tiles=bcsr_pair_from_graph(
        g, dtype, tile_rows=tile_rows, transpose=transpose))


# --------------------------------------------------------------------------
# The product: wrapper, kernel launch and plain version
# --------------------------------------------------------------------------

def check_tiles(tiles: BCSR) -> None:
    """Raise unless ``tiles`` is a tile store the kernels take."""
    v = tiles.values
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tile values must be float32 or bfloat16, "
                         f"got {v.dtype}")
    if v.dim() != 3 or v.shape[2] != TILE or v.shape[1] % TILE:
        raise ValueError(f"tile values must be [T, tr, {TILE}] with tr a "
                         f"multiple of {TILE}, got {tuple(v.shape)}")
    if tiles.n_rows % v.shape[1] or tiles.n_cols % TILE:
        raise ValueError(f"{tiles.n_rows} × {tiles.n_cols} is not a whole "
                         f"number of {v.shape[1]} × {TILE} tiles")
    for name in ("tile_rows", "tile_cols", "tile_ptr"):
        idx = getattr(tiles, name)
        if idx.dtype != torch.int32 or idx.device != v.device:
            raise ValueError(f"{name} must be int32 on {v.device}")
        if not idx.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not v.is_contiguous():
        raise ValueError("tile values must be contiguous")
    if tiles.tile_ptr.numel() != tiles.n_rows // v.shape[1] + 1:
        raise ValueError("tile_ptr must have n_rows // tr + 1 entries")
    for name in ("row_ptr", "col"):
        idx = getattr(tiles, name)
        if idx.dtype != torch.int32 or idx.device != v.device:
            raise ValueError(f"{name} must be int32 on {v.device}")
    if tiles.row_ptr.numel() != tiles.n_rows + 1:
        raise ValueError("row_ptr must have n_rows + 1 entries")
    if tiles.val.dtype != v.dtype or tiles.val.numel() != tiles.col.numel():
        raise ValueError("val must hold one value of the store's dtype "
                         "per column index")
    heavy = tiles.heavy[1]
    if heavy.dtype != torch.int32 or heavy.device != v.device:
        raise ValueError(f"heavy rows must be int32 on {v.device}")
    if tiles.view is not None:
        check_view(tiles, tiles.view)


def check_view(tiles: BCSR, view: TileView) -> None:
    """Raise unless ``view`` has the shape of a tile view of ``tiles``."""
    tr = tiles.tile_height
    if view.band != BAND or tr % view.band:
        raise ValueError(f"band {view.band} does not fit {tr}-tall tiles")
    n_bands = tiles.n_rows // view.band
    n_slots = n_bands * view.warps * WARP_ROWS
    for name, n in (("stage_ptr", n_bands + 1), ("slot_rows", n_slots),
                    ("stages", None), ("blocks", None)):
        x = getattr(view, name)
        if (x.dtype != torch.int32 or x.device != tiles.values.device
                or not x.is_contiguous()
                or (n is not None and x.numel() != n)):
            raise ValueError(f"view.{name} must be {n or 'contiguous'} "
                             f"int32 on {tiles.values.device}")
    if view.stages.dim() != 2 or view.stages.shape[1] != 4:
        raise ValueError("view.stages must be [S, 4]")
    if tiles.values.is_cuda:
        check_layout(tiles.values.element_size())


def check_operand(tiles: BCSR, x: torch.Tensor, max_rows: int,
                  name: str) -> None:
    """Raise unless ``x`` is a contiguous 2-D f32 tensor on the tiles'
    device with at most ``max_rows`` rows."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name} must be a 2-D float32 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != tiles.values.device:
        raise ValueError(f"{name} is on {x.device}, the tiles on "
                         f"{tiles.values.device}")
    n, d = x.shape
    if n > max_rows:
        raise ValueError(f"{name} has {n} rows; the tiles cover "
                         f"{max_rows}")
    if d < 1 or d >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{name} of shape {tuple(x.shape)} is out of "
                         f"range")


def vector_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the kernels read an operand: in ``dtype``, with a row
    stride that is a whole number of 16-byte vectors and a 16-byte aligned
    start. ``x`` itself where it already is so, else one copy (which also
    casts). Columns past ``x``'s are left unset: K1 never writes them and
    K2 masks them."""
    n, d = x.shape
    step = 16 // dtype.itemsize
    ld = _round_up(d, step)
    if ld == d:
        y = x.to(dtype)
        if y.data_ptr() % 16 == 0:
            return y
    y = torch.empty(n, ld, dtype=dtype, device=x.device)
    y[:, :d] = x
    return y


def bcsr_spmm_cuda(tiles: BCSR, h: torch.Tensor, n_out: int,
                   view="auto") -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. ``view``:
    ``"auto"`` takes the store's own route (its view, else the walk); a
    :class:`TileView` of the store takes the staged route on it, None the
    walk. Every output row is written by the kernel, so the output is
    ``torch.empty``."""
    n, d = h.shape
    v = tiles.values
    view = tiles.view if isinstance(view, str) else view
    if n == 0:      # no rows of H: every column reads as zero
        h = torch.zeros(1, d, dtype=torch.float32, device=h.device)
        n = 1
    # as pallas_spmm.py:135-140: H is rounded to bf16 before the kernel
    hk = vector_rows(h, v.dtype)
    out = torch.empty(n_out, d, dtype=torch.float32, device=h.device)
    kind = "f32" if v.dtype == torch.float32 else "bf16"
    if view is None:
        route = "walk"
        heavy_min, heavy = tiles.heavy
        # a heavy row's eight sums for each column chunk of a warp (16
        # bytes of H a lane)
        chunk = 32 * (16 // v.element_size())
        part = torch.empty(heavy.numel() * -(-hk.shape[1] // chunk) * 8
                           * chunk, dtype=torch.float32, device=h.device)
        _build.launch(
            "bcsr_spmm", f"bcsr_spmm_{kind}", h.device,
            [tiles.row_ptr.data_ptr(), tiles.col.data_ptr(),
             tiles.val.data_ptr(), hk.data_ptr(), heavy.data_ptr(),
             part.data_ptr(), out.data_ptr()],
            [n_out, d, hk.shape[1], n, heavy.numel(), heavy_min])
    else:
        route = "staged"
        check_view(tiles, view)
        _build.launch(
            "bcsr_spmm", f"bcsr_spmm_staged_{kind}", h.device,
            [view.stage_ptr.data_ptr(), view.stages.data_ptr(),
             view.blocks.data_ptr(), view.slot_rows.data_ptr(),
             hk.data_ptr(), out.data_ptr()],
            [n_out, d, hk.shape[1], n])
    bcsr_spmm.launches += 1
    bcsr_spmm.routes[f"{route}_{kind}"] += 1
    return out


def k1_launch_shape(tiles: BCSR, d: int, n_out: int, view="auto") -> dict:
    """What a launch of K1 on the staged route over ``view`` moves: its
    stages (slab and entry-block copies, a band's stages for each column
    chunk) and the slab bytes they copy from L2; for a store on the card
    also the blocks, threads and dynamic shared memory a block, as the
    kernel's launch computes them (:func:`staged_describe`). ``{"route":
    "walk"}`` on the walk."""
    view = tiles.view if isinstance(view, str) else view
    if view is None:
        return {"route": "walk"}
    item = tiles.values.element_size()
    chunks = -(-d // STAGED_CHUNK)
    n_st = int(view.stage_ptr[-(-n_out // view.band)])
    out = {"route": "staged", "band": view.band, "stages": n_st * chunks,
           "slab_mb": n_st * chunks * TILE * STAGED_CHUNK * item / 1e6,
           "reuse": view.reuse}
    if tiles.values.is_cuda:
        check_layout(item)
        launch = staged_describe(item, n_out, d)
        out.update({k: launch[k] for k in ("blocks", "threads",
                                           "smem_bytes")})
    return out


def bcsr_spmm_plain(tiles: BCSR, h: torch.Tensor,
                    n_out: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over tiles,
    ``out[r-block] += A_t.float() @ H[c-block]``, with H rounded to bf16
    first when the tiles are bf16 (each bf16 product is exact in f32).
    Returns the first ``n_out`` rows (default: as many as ``h`` has)."""
    n, d = h.shape
    tr = tiles.tile_height
    hp = torch.zeros(tiles.n_cols, d, dtype=torch.float32, device=h.device)
    hp[:n] = h
    if tiles.values.dtype == torch.bfloat16:
        hp = hp.to(torch.bfloat16).float()
    out = torch.zeros(tiles.n_rows, d, dtype=torch.float32, device=h.device)
    for t, (r, c) in enumerate(zip(tiles.tile_rows.tolist(),
                                   tiles.tile_cols.tolist())):
        out[r * tr:(r + 1) * tr] += (tiles.values[t].float()
                                     @ hp[c * TILE:(c + 1) * TILE])
    return out[:n if n_out is None else n_out]


def bcsr_matmul(tiles: BCSR, h: torch.Tensor,
                n_out: int | None = None) -> torch.Tensor:
    """The first ``n_out`` rows (default: ``h``'s row count) of M @ h for
    one tile set, square or rectangular; not differentiable. h is
    ``[n, d]`` f32 with n ≤ ``tiles.n_cols`` (rows past n read as zero)
    and n_out ≤ ``tiles.n_rows``; out is ``[n_out, d]`` f32.

    A CUDA tensor launches the kernel on the store's route (or raises); a
    CPU tensor takes the plain version. ``bcsr_spmm.launches`` counts
    kernel launches, ``bcsr_spmm.routes`` them by route and type.
    """
    n_out = h.shape[0] if n_out is None else n_out
    check_tiles(tiles)
    check_operand(tiles, h, tiles.n_cols, "h")
    if not 0 < n_out <= tiles.n_rows:
        raise ValueError(f"n_out={n_out}; the tiles have {tiles.n_rows} "
                         f"rows")
    if h.device.type == "cpu":
        return bcsr_spmm_plain(tiles, h, n_out)
    if h.device.type != "cuda":
        raise ValueError(f"bcsr_spmm runs on cuda or cpu, not {h.device}")
    return bcsr_spmm_cuda(tiles, h, n_out)


class _BCSRSpMM(torch.autograd.Function):
    """K1 forward on ``pair.fwd``, K1 backward on ``pair.bwd``
    (``pallas_spmm.py:234-246``)."""

    @staticmethod
    def forward(ctx, h, pair):
        ctx.pair = pair
        return bcsr_matmul(pair.fwd, h)

    @staticmethod
    def backward(ctx, g):
        with span("spmm"):
            return bcsr_matmul(ctx.pair.bwd, g.float().contiguous()), None


def bcsr_spmm(pair: BCSRPair, h: torch.Tensor) -> torch.Tensor:
    """out = A @ h for the tile pair of a square adjacency; h is
    ``[n, d]`` f32, out ``[n, d]`` f32. Differentiable in h: the backward
    is Aᵀ @ g on the transposed tiles, which a forward-only pair lacks.
    ``bcsr_spmm.launches`` counts K1 launches, forward and backward, from
    every caller."""
    if pair.bwd is None and h.requires_grad and torch.is_grad_enabled():
        raise ValueError("this tile pair was built without its transposed "
                         "tiles (transpose=False) and takes no gradient")
    return _BCSRSpMM.apply(h, pair)


class _BCSRSpMMRect(torch.autograd.Function):
    """K1 forward on ``pair.fwd``, K1 backward on ``pair.bwd``, for a
    rectangular pair (``pallas_spmm.py:254-281``)."""

    @staticmethod
    def forward(ctx, buf, pair, n_out):
        ctx.pair, ctx.n_buf = pair, buf.shape[0]
        return bcsr_matmul(pair.fwd, buf, n_out)

    @staticmethod
    def backward(ctx, g):
        with span("spmm"):
            return (bcsr_matmul(ctx.pair.bwd, g.float().contiguous(),
                                ctx.n_buf), None, None)


def bcsr_spmm_rect(pair: BCSRPair, buf: torch.Tensor,
                   n_out: int) -> torch.Tensor:
    """out = (M @ buf)[:n_out] for a rectangular pair (fwd ``[n_rows ×
    n_cols]``, bwd its transpose); ``buf`` is ``[≤ n_cols, d]`` f32, out
    ``[n_out, d]`` f32. Differentiable in ``buf`` through the transposed
    set. The halo-sharded SpMM runs it on each shard's local and remote
    pairs. Counts into ``bcsr_spmm.launches``."""
    return _BCSRSpMMRect.apply(buf.contiguous(), pair, n_out)


bcsr_spmm.launches = 0
bcsr_spmm.routes = {f"{r}_{k}": 0 for r in ("staged", "walk")
                    for k in ("f32", "bf16")}
