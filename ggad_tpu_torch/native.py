"""ctypes binding of the port's host graph builder, ``csrc/graphbuild.cpp``
(counterpart of ``ggad_tpu/native.py``: the same functions and argument
names).

The library is compiled with the host's C++ compiler at first use into
``ggad_tpu_torch/build/`` (``ops/_build.py::build_host``); nothing is built
when this module is imported. :func:`available` is False only when the host
has no C++ compiler: the callers (``graph.from_coo``,
``datasets/synthetic.py``, ``ops/bcsr_spmm.bcsr_from_coo``,
``datasets/partition.py``) then take their Python/numpy routes, which give
the same arrays. A compile or load that fails raises with the compiler's
output, and an entry point called with no compiler raises: nothing falls
back quietly.

``calls`` counts each entry point's calls into the library, as the kernels'
wrappers count their launches, so a run can show which route a build took.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ggad_tpu_torch.ops import _build

ENTRY_POINTS = ("sort_coo", "symmetrize", "build_indptr",
                "sym_normalize_vals", "bcsr_build", "sample_neighbors_host",
                "partition_refine", "hem_match")
calls = dict.fromkeys(ENTRY_POINTS, 0)

_lib: Optional[ctypes.CDLL] = None
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32, _i64, _u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    "gg_sort_coo": (ctypes.c_int, [_i64, _i32p, _i32p, _f32p]),
    "gg_symmetrize": (_i64, [_i64, _i32p, _i32p, _f32p, _i32p, _i32p,
                             _f32p]),
    "gg_build_indptr": (ctypes.c_int, [_i64, _i32, _i32p, _i32p]),
    "gg_sym_normalize": (ctypes.c_int, [_i64, _i32, _i32p, _i32p, _f32p]),
    "gg_bcsr_count": (_i64, [_i64, _i32, _i32p, _i32p, _i64p]),
    "gg_bcsr_fill": (ctypes.c_int, [_i64, _i32, _i64, _i32p, _i32p, _f32p,
                                    _i64p, _i32p, _i32p, _f32p]),
    "gg_sample_neighbors": (ctypes.c_int, [_i64, _i32p, _i32p, _i32p, _i32,
                                           _u64, _i32p, _f32p]),
    "gg_partition_refine": (_i64, [_i32, _i32, _i64, _i32p, _i32p, _f32p,
                                   _i32p, _i32p, _i32, _u64]),
    "gg_hem_match": (_i64, [_i32, _i32p, _i32p, _f32p, _u64, _i32p]),
}


def available() -> bool:
    """True when the library is loaded or a C++ compiler can build it."""
    return _lib is not None or _build.cxx_path() is not None


def load() -> ctypes.CDLL:
    """The loaded library, built at first use (under ``_build``'s lock).
    Raises when there is no compiler, or with the compiler's output when
    the build fails."""
    global _lib
    with _build._lock:
        if _lib is None:
            path, _ = _build.build_host("graphbuild")
            lib = ctypes.CDLL(str(path))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def _enter(name: str) -> ctypes.CDLL:
    lib = load()
    calls[name] += 1
    return lib


def _p(arr, ctype):
    return None if arr is None else arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i32_array(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int32)


def sort_coo(rows: np.ndarray, cols: np.ndarray,
             vals: Optional[np.ndarray]):
    """Sort edges by (row, col), stably (duplicate pairs keep their input
    order, as ``np.lexsort``); returns new int32 / float32 arrays."""
    rows = _i32_array(rows).copy()
    cols = _i32_array(cols).copy()
    vals = (np.ascontiguousarray(vals, np.float32).copy()
            if vals is not None else None)
    _enter("sort_coo").gg_sort_coo(len(rows), _p(rows, ctypes.c_int32),
                                   _p(cols, ctypes.c_int32),
                                   _p(vals, ctypes.c_float))
    return rows, cols, vals


def symmetrize(rows: np.ndarray, cols: np.ndarray,
               vals: Optional[np.ndarray]):
    """Union-symmetrize max(A, Aᵀ) with duplicates merged (their max);
    returns arrays sorted by (row, col)."""
    rows, cols = _i32_array(rows), _i32_array(cols)
    vals = (np.ascontiguousarray(vals, np.float32) if vals is not None
            else np.ones(len(rows), np.float32))
    m = 2 * len(rows)
    orow = np.empty(m, np.int32)
    ocol = np.empty(m, np.int32)
    oval = np.empty(m, np.float32)
    n = _enter("symmetrize").gg_symmetrize(
        len(rows), _p(rows, ctypes.c_int32), _p(cols, ctypes.c_int32),
        _p(vals, ctypes.c_float), _p(orow, ctypes.c_int32),
        _p(ocol, ctypes.c_int32), _p(oval, ctypes.c_float))
    return orow[:n].copy(), ocol[:n].copy(), oval[:n].copy()


def build_indptr(rows: np.ndarray, n_nodes: int) -> np.ndarray:
    """CSR row pointers ``[n_nodes + 1]`` (int32) of sorted ``rows``."""
    rows = _i32_array(rows)
    indptr = np.zeros(n_nodes + 1, np.int32)
    _enter("build_indptr").gg_build_indptr(len(rows), n_nodes,
                                           _p(rows, ctypes.c_int32),
                                           _p(indptr, ctypes.c_int32))
    return indptr


def sym_normalize_vals(rows: np.ndarray, cols: np.ndarray,
                       vals: np.ndarray, n_nodes: int) -> np.ndarray:
    """``val_e · d^-1/2[row_e] · d^-1/2[col_e]`` with weighted row-sum
    degrees (summed in f64)."""
    rows, cols = _i32_array(rows), _i32_array(cols)
    vals = np.ascontiguousarray(vals, np.float32).copy()
    _enter("sym_normalize_vals").gg_sym_normalize(
        len(rows), n_nodes, _p(rows, ctypes.c_int32),
        _p(cols, ctypes.c_int32), _p(vals, ctypes.c_float))
    return vals


def bcsr_build(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_pad_tiles: int):
    """128 × 128 tile-COO build: (tile_rows, tile_cols, values
    ``[T, 128, 128]`` f32), tiles sorted by (tile row, tile column),
    duplicate edges added in input order."""
    rows, cols = _i32_array(rows), _i32_array(cols)
    vals = np.ascontiguousarray(vals, np.float32)
    lib = _enter("bcsr_build")
    tile_ids = np.empty(len(rows), np.int64)
    n_tiles = lib.gg_bcsr_count(len(rows), n_pad_tiles,
                                _p(rows, ctypes.c_int32),
                                _p(cols, ctypes.c_int32),
                                _p(tile_ids, ctypes.c_int64))
    tile_rows = np.empty(n_tiles, np.int32)
    tile_cols = np.empty(n_tiles, np.int32)
    values = np.zeros((n_tiles, 128, 128), np.float32)
    rc = lib.gg_bcsr_fill(len(rows), n_pad_tiles, n_tiles,
                          _p(rows, ctypes.c_int32), _p(cols, ctypes.c_int32),
                          _p(vals, ctypes.c_float),
                          _p(tile_ids, ctypes.c_int64),
                          _p(tile_rows, ctypes.c_int32),
                          _p(tile_cols, ctypes.c_int32),
                          _p(values, ctypes.c_float))
    if rc != 0:
        raise RuntimeError(f"gg_bcsr_fill failed ({rc})")
    return tile_rows, tile_cols, values


def sample_neighbors_host(query: np.ndarray, indptr: np.ndarray,
                          indices: np.ndarray, fanout: int,
                          seed: int = 0):
    """Uniform with-replacement fixed-fanout sampling from a CSR graph
    (``mt19937_64`` seeded with ``seed``): (neighbours ``[Q, fanout]``
    int32, mask f32); a node with no edge gets itself, mask 0."""
    query, indptr = _i32_array(query), _i32_array(indptr)
    indices = _i32_array(indices)
    neigh = np.empty((len(query), fanout), np.int32)
    mask = np.empty((len(query), fanout), np.float32)
    _enter("sample_neighbors_host").gg_sample_neighbors(
        len(query), _p(query, ctypes.c_int32), _p(indptr, ctypes.c_int32),
        _p(indices, ctypes.c_int32), fanout, seed,
        _p(neigh, ctypes.c_int32), _p(mask, ctypes.c_float))
    return neigh, mask


def partition_refine(indptr: np.ndarray, indices: np.ndarray,
                     part: np.ndarray, n_parts: int, cap: int,
                     rounds: int = 10, seed: int = 1,
                     weights: Optional[np.ndarray] = None,
                     node_w: Optional[np.ndarray] = None) -> np.ndarray:
    """Capacity-bounded asynchronous label propagation
    (``datasets.partition.partition_refine_python`` is its Python copy);
    returns the refined labels."""
    part = _i32_array(part).copy()
    indptr, indices = _i32_array(indptr), _i32_array(indices)
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
    if node_w is not None:
        node_w = _i32_array(node_w)
    _enter("partition_refine").gg_partition_refine(
        len(part), n_parts, cap, _p(indptr, ctypes.c_int32),
        _p(indices, ctypes.c_int32), _p(weights, ctypes.c_float),
        _p(node_w, ctypes.c_int32), _p(part, ctypes.c_int32), rounds, seed)
    return part


def hem_match(indptr: np.ndarray, indices: np.ndarray,
              weights: Optional[np.ndarray] = None,
              seed: int = 1) -> np.ndarray:
    """Heavy-edge matching (``datasets.partition.hem_match_python`` is its
    Python copy): ``partner[i]`` is i's matched peer, or i."""
    indptr, indices = _i32_array(indptr), _i32_array(indices)
    if weights is not None:
        weights = np.ascontiguousarray(weights, np.float32)
    partner = np.empty(len(indptr) - 1, np.int32)
    _enter("hem_match").gg_hem_match(
        len(partner), _p(indptr, ctypes.c_int32),
        _p(indices, ctypes.c_int32), _p(weights, ctypes.c_float), seed,
        _p(partner, ctypes.c_int32))
    return partner
