"""Sparse graph structure for message passing (counterpart of
``ggad_tpu/graph.py``).

A :class:`Graph` holds tensors on one device: COO edges sorted by
(row, col), padded to a multiple of ``pad_multiple`` with padding edges
that carry ``val == 0`` and ``row == col == 0``, plus CSR ``indptr`` rows
pointers into the unpadded range. Builders run on the host (numpy) and
move the result to ``device`` once. Index tensors are int64, PyTorch's
index type.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ggad_tpu_torch import native
from ggad_tpu_torch.device import DeviceLike, resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """A sparse graph in sorted-COO form (+ CSR indptr).

    Attributes:
      row:    [E_pad] int64, source node of each edge (sorted ascending).
      col:    [E_pad] int64, destination node of each edge.
      val:    [E_pad] float32, edge weight (0.0 on padding edges).
      indptr: [N+1] int64 CSR row pointers into the unpadded edge range.
      n_nodes: number of nodes N.
      n_edges: number of real (non-padding) edges E.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    indptr: torch.Tensor
    n_nodes: int
    n_edges: int

    @property
    def e_pad(self) -> int:
        return self.row.shape[0]

    @property
    def device(self) -> torch.device:
        return self.val.device

    def out_degrees(self) -> torch.Tensor:
        """Weighted out-degree per node: sum of val over rows."""
        return torch.zeros(self.n_nodes, dtype=self.val.dtype,
                           device=self.device).index_add_(0, self.row,
                                                          self.val)

    def in_degrees(self) -> torch.Tensor:
        """Weighted in-degree per node: sum of val over cols."""
        return torch.zeros(self.n_nodes, dtype=self.val.dtype,
                           device=self.device).index_add_(0, self.col,
                                                          self.val)

    def with_val(self, val: torch.Tensor) -> "Graph":
        return dataclasses.replace(self, val=val)

    def host_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The unpadded (row, col, val) edge list as numpy arrays."""
        e = self.n_edges
        return (self.row[:e].cpu().numpy(), self.col[:e].cpu().numpy(),
                self.val[:e].cpu().numpy())

    def transpose_host(self) -> "Graph":
        """Transpose (swap row/col) and re-sort, on the host, keeping
        ``e_pad`` (``ggad_tpu/graph.py:75-80``); the result is on this
        graph's device."""
        row, col, val = self.host_coo()
        return from_coo(col, row, val, self.n_nodes, e_pad=self.e_pad,
                        device=self.device)


def from_coo(
    row: np.ndarray,
    col: np.ndarray,
    val: Optional[np.ndarray],
    n_nodes: int,
    *,
    e_pad: Optional[int] = None,
    pad_multiple: int = 512,
    device: DeviceLike = None,
) -> Graph:
    """Build a Graph from host-side COO arrays. Sorts by (row, col), pads.

    Duplicate edges are preserved (summed implicitly by SpMM), matching
    scipy's COO semantics under matmul. Above 1M edges the sort runs in
    the host library (``native.sort_coo``, as ``ggad_tpu/graph.py:105-109``),
    stable as ``np.lexsort`` is, so both routes give the same order.
    """
    device = resolve_device(device)
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    n_edges = int(row.shape[0])
    if val is None:
        val = np.ones(n_edges, dtype=np.float32)
    val = np.asarray(val, dtype=np.float32)

    if n_edges > 1_000_000 and native.available():
        row32, col32, val = native.sort_coo(row, col, val)
        row, col = row32.astype(np.int64), col32.astype(np.int64)
    else:
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]

    if e_pad is None:
        e_pad = max(_round_up(max(n_edges, 1), pad_multiple), pad_multiple)
    if e_pad < n_edges:
        raise ValueError(f"e_pad={e_pad} < n_edges={n_edges}")

    row_p = np.zeros(e_pad, dtype=np.int64)
    col_p = np.zeros(e_pad, dtype=np.int64)
    val_p = np.zeros(e_pad, dtype=np.float32)
    row_p[:n_edges] = row
    col_p[:n_edges] = col
    val_p[:n_edges] = val

    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(row, minlength=n_nodes))

    return Graph(
        row=torch.from_numpy(row_p).to(device),
        col=torch.from_numpy(col_p).to(device),
        val=torch.from_numpy(val_p).to(device),
        indptr=torch.from_numpy(indptr).to(device),
        n_nodes=int(n_nodes),
        n_edges=n_edges,
    )


def from_scipy(mat, *, pad_multiple: int = 512,
               device: DeviceLike = None) -> Graph:
    """Build a Graph from any scipy sparse matrix."""
    coo = mat.tocoo()
    return from_coo(coo.row, coo.col, coo.data, coo.shape[0],
                    pad_multiple=pad_multiple, device=device)


def to_scipy(g: Graph):
    """Back to a scipy CSR matrix, padding dropped (``graph.py:149-157``);
    duplicate edges are summed."""
    import scipy.sparse as sp

    row, col, val = g.host_coo()
    return sp.coo_matrix((val, (row, col)),
                         shape=(g.n_nodes, g.n_nodes)).tocsr()


def coalesce(row, col, val, n_nodes):
    """Host-side: sum duplicate (row, col) entries (``graph.py:215-221``);
    the result is sorted by (row, col)."""
    key = row.astype(np.int64) * n_nodes + col.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    out_val = np.zeros(uniq.shape[0], dtype=np.float32)
    np.add.at(out_val, inv, val)
    return ((uniq // n_nodes).astype(np.int64),
            (uniq % n_nodes).astype(np.int64), out_val)


def rows_subgraph(g: Graph, rows) -> Graph:
    """Rectangular row-subgraph (``ggad_tpu/graph.py:160-195``): the edges
    of ``rows`` with row indices renumbered 0..len(rows)-1 in the order
    given; columns stay global.

    ``spmm(sub, x)`` then computes ``(A @ x)[rows]`` in O(E_rows), forward
    and backward (GGAD's generator aggregation, reference
    ``model.py:151-156``). The result's ``n_nodes`` is len(rows), the row
    count; only ``spmm`` semantics hold, not the degree helpers.
    """
    rows = np.asarray(rows, dtype=np.int64)
    r, c, v = g.host_coo()
    lookup = np.full(g.n_nodes, -1, np.int64)
    lookup[rows] = np.arange(len(rows))
    sel = lookup[r] >= 0
    new_r = lookup[r[sel]]
    order = np.argsort(new_r, kind="stable")
    new_r, new_c, new_v = new_r[order], c[sel][order], v[sel][order]

    n_e = len(new_r)
    e_pad = max(_round_up(max(n_e, 1), 8), 8)
    row_p = np.zeros(e_pad, np.int64)
    col_p = np.zeros(e_pad, np.int64)
    val_p = np.zeros(e_pad, np.float32)
    row_p[:n_e], col_p[:n_e], val_p[:n_e] = new_r, new_c, new_v
    indptr = np.zeros(len(rows) + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(new_r, minlength=len(rows)))
    return Graph(
        row=torch.from_numpy(row_p).to(g.device),
        col=torch.from_numpy(col_p).to(g.device),
        val=torch.from_numpy(val_p).to(g.device),
        indptr=torch.from_numpy(indptr).to(g.device),
        n_nodes=len(rows),
        n_edges=n_e,
    )


def add_self_loops(g: Graph, weight: float = 1.0) -> Graph:
    """Return A + weight·I as a new Graph (host-side rebuild).

    Matches the reference's ``adj + sp.eye(N)`` (``run.py:100-101``). An
    existing self-loop is not merged: the identity entry is appended as a
    separate duplicate edge, exactly like ``ggad_tpu.graph.add_self_loops``.
    """
    row, col, val = g.host_coo()
    loops = np.arange(g.n_nodes, dtype=np.int64)
    row = np.concatenate([row, loops])
    col = np.concatenate([col, loops])
    val = np.concatenate([val, np.full(g.n_nodes, weight, dtype=np.float32)])
    return from_coo(row, col, val, g.n_nodes, device=g.device)
