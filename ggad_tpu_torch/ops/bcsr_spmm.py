"""Block-sparse (BCSR) SpMM — counterpart of ``ggad_tpu/ops/pallas_spmm.py``.

The adjacency is stored as its occupied tiles (tile-COO, sorted by
(tile_row, tile_col)); tile t is a ``[tr, 128]`` block at rows
``tile_rows[t]·tr`` and columns ``tile_cols[t]·128``, and

    out[tile_row block] += A_t @ H[tile_col block]

The product runs in the hand-written CUDA kernel ``csrc/bcsr_spmm.cu``
(K1's port) for CUDA tensors and in :func:`bcsr_spmm_plain`, a loop over
tiles with the kernel's arithmetic, for CPU tensors. Serving builds only
the forward tile set; the transposed set and the autograd backward come
with the training slice.
"""

from __future__ import annotations

import ctypes
import dataclasses

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


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Tile-COO block-sparse matrix (tiles sorted by (tile_row, tile_col)).

    ``tile_ptr[r] .. tile_ptr[r+1]`` are the tiles of tile row r; the
    kernel walks a tile row through it.
    """

    tile_rows: torch.Tensor  # [T] int32
    tile_cols: torch.Tensor  # [T] int32
    tile_ptr: torch.Tensor   # [n_rows // tr + 1] int32
    values: torch.Tensor     # [T, tr, TILE] float32 or bfloat16
    n_rows: int              # padded to a multiple of tr
    n_cols: int              # padded to a multiple of TILE

    @property
    def n_tiles(self) -> int:
        return self.values.shape[0]

    @property
    def tile_height(self) -> int:
        return self.values.shape[1]

    def with_dtype(self, dtype) -> "BCSR":
        return dataclasses.replace(
            self, values=self.values.to(storage_dtype(dtype)))


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
class BCSRGraph:
    """A Graph plus its forward BCSR tiles; drop-in for ``ops.spmm``."""

    graph: object            # ggad_tpu_torch.graph.Graph
    tiles: BCSR

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


def as_bcsr_graph(g, dtype="float32",
                  tile_rows: int | None = None) -> BCSRGraph:
    """Build ``g``'s forward tiles on ``g``'s device. ``tile_rows=None``
    picks the height with :func:`pick_tile_rows`. bf16 tiles are the f32
    build rounded once, as the JAX package builds them."""
    row, col, val = g.host_coo()
    if tile_rows is None:
        tile_rows = pick_tile_rows(row, col, g.n_nodes)
    tiles = bcsr_from_coo(row, col, val, g.n_nodes, tile_rows=tile_rows,
                          device=g.device)
    return BCSRGraph(graph=g, tiles=tiles.with_dtype(dtype))


# --------------------------------------------------------------------------
# The product: wrapper, kernel launch and plain version
# --------------------------------------------------------------------------

def _check(tiles: BCSR, h: torch.Tensor) -> None:
    v = tiles.values
    if h.dim() != 2 or h.dtype != torch.float32:
        raise ValueError(f"h must be a 2-D float32 tensor, got "
                         f"{h.dtype} of shape {tuple(h.shape)}")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    if h.device != v.device:
        raise ValueError(f"h is on {h.device}, the tiles on {v.device}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tile values must be float32 or bfloat16, "
                         f"got {v.dtype}")
    if v.dim() != 3 or v.shape[2] != TILE or v.shape[1] % TILE:
        raise ValueError(f"tile values must be [T, tr, {TILE}] with tr a "
                         f"multiple of {TILE}, got {tuple(v.shape)}")
    if tiles.n_rows % v.shape[1]:
        raise ValueError(f"n_rows={tiles.n_rows} is not a multiple of the "
                         f"tile height {v.shape[1]}")
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
    n, d = h.shape
    if n > tiles.n_cols or n > tiles.n_rows:
        raise ValueError(f"h has {n} rows; the tiles cover "
                         f"{tiles.n_rows} × {tiles.n_cols}")
    if d < 1 or d >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"h of shape {tuple(h.shape)} is out of range")


def _kernel_entry(dtype: torch.dtype):
    lib = _build.load("bcsr_spmm")
    fn = lib.bcsr_spmm_f32 if dtype == torch.float32 else lib.bcsr_spmm_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bcsr_spmm_cuda(tiles: BCSR, h: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Every output
    element is written by the kernel, so the output is ``torch.empty``."""
    n, d = h.shape
    v = tiles.values
    # as pallas_spmm.py:135-140: H is rounded to bf16 before the kernel
    hk = h if v.dtype == torch.float32 else h.to(torch.bfloat16)
    out = torch.empty(n, d, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = _kernel_entry(v.dtype)(
            v.data_ptr(), tiles.tile_cols.data_ptr(),
            tiles.tile_ptr.data_ptr(), hk.data_ptr(), out.data_ptr(),
            tiles.n_rows // v.shape[1], v.shape[1], d, n, n, stream)
    if rc != 0:
        raise RuntimeError(f"bcsr_spmm kernel launch failed: CUDA error {rc}")
    bcsr_spmm.launches += 1
    return out


def bcsr_spmm_plain(tiles: BCSR, h: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over tiles,
    ``out[r-block] += A_t.float() @ H[c-block]``, with H rounded to bf16
    first when the tiles are bf16 (each bf16 product is exact in f32)."""
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
    return out[:n]


def bcsr_spmm(tiles: BCSR, h: torch.Tensor) -> torch.Tensor:
    """out = M @ h for the forward tile set ``tiles``; h is ``[n, d]`` f32
    with n ≤ the tiles' padded sizes (rows past n read as zero), out is
    ``[n, d]`` f32.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version. ``bcsr_spmm.launches`` counts kernel launches. Not yet
    differentiable: the backward on the transposed tiles comes with the
    training slice.
    """
    if h.requires_grad:
        raise NotImplementedError(
            "bcsr_spmm has no backward yet (training slice, ROADMAP "
            "Queue 1); call it under torch.no_grad()")
    _check(tiles, h)
    if h.device.type == "cpu":
        return bcsr_spmm_plain(tiles, h)
    if h.device.type != "cuda":
        raise ValueError(f"bcsr_spmm runs on cuda or cpu, not {h.device}")
    return bcsr_spmm_cuda(tiles, h)


bcsr_spmm.launches = 0
