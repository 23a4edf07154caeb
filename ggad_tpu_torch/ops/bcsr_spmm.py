"""Block-sparse (BCSR) SpMM — counterpart of ``ggad_tpu/ops/pallas_spmm.py``.

The adjacency is stored as its occupied tiles (tile-COO, sorted by
(tile_row, tile_col)); tile t is a ``[tr, 128]`` block at rows
``tile_rows[t]·tr`` and columns ``tile_cols[t]·128``, and

    out[tile_row block] += A_t @ H[tile_col block]

Beside the tile store every :class:`BCSR` holds the compressed rows of its
stored non-zeros (``row_ptr``, ``col``, ``val``), derived from the stored
values when the tiles are built. The hand-written CUDA kernel
``csrc/bcsr_spmm.cu`` (K1's port) walks those rows for CUDA tensors;
:func:`bcsr_spmm_plain`, a loop over tiles with the kernel's arithmetic,
computes the product for CPU tensors.

A graph carries a :class:`BCSRPair`: the forward tile set and, for
training, the tile set of the transpose (serving builds only the forward
set). :func:`bcsr_spmm` is differentiable in H; its backward is K1 again,
on the transposed set. The adjacency is not trained and gets no
gradient. Rectangular tile sets (:func:`bcsr_rect_from_coo`) feed the
SDDMM's backward, where the product's output rows differ from H's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.ops import _build

TILE = 128  # tile width (and the unit of tile heights)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def storage_dtype(dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (the trainer's ``spmm_dtype``) or a
    torch dtype → the tile store's torch dtype."""
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"BCSR tiles are float32 or bfloat16, not {dtype}")
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


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Tile-COO block-sparse matrix (tiles sorted by (tile_row, tile_col)).

    ``tile_ptr[r] .. tile_ptr[r+1]`` are the tiles of tile row r.
    ``row_ptr``, ``col`` and ``val`` are the stored non-zeros in compressed
    rows (:func:`tile_csr`), built once with the tiles, on their device;
    the kernels walk them. A copy with other values (``with_dtype``)
    derives them anew.
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

    def __post_init__(self):
        csr = tile_csr(self.tile_rows, self.tile_cols, self.values,
                       self.n_rows)
        for name, x in zip(("row_ptr", "col", "val"), csr):
            object.__setattr__(self, name, x)

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
    """Host-side float32 BCSR build, the numpy route of
    ``ggad_tpu.ops.pallas_spmm.bcsr_from_coo``: duplicate edges are summed
    with ``np.add.at``. ``tile_rows`` is the tile height (a multiple of
    128)."""
    if tile_rows <= 0 or tile_rows % TILE:
        raise ValueError(f"tile_rows={tile_rows} is not a multiple of {TILE}")
    device = resolve_device(device)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    n_row_pad = _round_up(max(n_nodes, tile_rows), tile_rows)
    n_col_pad = _round_up(max(n_nodes, TILE), TILE)
    nct = n_col_pad // TILE
    tkey = (row // tile_rows) * nct + col // TILE
    uniq, inv = np.unique(tkey, return_inverse=True)
    values = np.zeros((len(uniq), tile_rows, TILE), np.float32)
    np.add.at(values, (inv, row % tile_rows, col % TILE), val)
    # np.unique returns sorted keys → already (tile_row, tile_col) sorted.
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


def bcsr_spmm_cuda(tiles: BCSR, h: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Every output
    row is written by the kernel, so the output is ``torch.empty``."""
    n, d = h.shape
    v = tiles.values
    # as pallas_spmm.py:135-140: H is rounded to bf16 before the kernel
    hk = vector_rows(h, v.dtype)
    out = torch.empty(n_out, d, dtype=torch.float32, device=h.device)
    _build.launch(
        "bcsr_spmm",
        "bcsr_spmm_f32" if v.dtype == torch.float32 else "bcsr_spmm_bf16",
        h.device,
        [tiles.row_ptr.data_ptr(), tiles.col.data_ptr(),
         tiles.val.data_ptr(), hk.data_ptr(), out.data_ptr()],
        [n_out, d, hk.shape[1], n])
    bcsr_spmm.launches += 1
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

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version. ``bcsr_spmm.launches`` counts kernel launches.
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


bcsr_spmm.launches = 0
