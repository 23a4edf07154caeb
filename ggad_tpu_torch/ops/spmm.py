"""Sparse matrix × dense matrix (SpMM): out[r] = Σ_e val[e] · X[col[e]]
(counterpart of ``ggad_tpu/ops/spmm.py``).

The COO path is gather + ``index_add_`` (O(E·d)); a graph that carries
BCSR tiles (:class:`~ggad_tpu_torch.ops.bcsr_spmm.BCSRGraph`) goes through
the hand-written block-sparse kernel instead.
"""

from __future__ import annotations

import torch

from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm


def spmm_coo(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """COO SpMM via gather + ``index_add_``. Padding edges must have
    val == 0 (their gathered row contributes 0)."""
    out = torch.zeros(n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, row, x[col] * val[:, None])


def spmm(g, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Compute A @ x for the sparse adjacency held by ``g``.

    Dispatch on the graph type, as ``ggad_tpu.ops.spmm.spmm`` does: a
    BCSRGraph runs the BCSR kernel unless ``impl='coo'`` (JAX's
    ``'xla'``) forces the gather path.
    """
    if impl not in ("auto", "coo"):
        raise ValueError(f"unknown spmm impl {impl!r}")
    if isinstance(g, BCSRGraph) and impl == "auto":
        return bcsr_spmm(g.tiles, x)
    return spmm_coo(g.row, g.col, g.val, x, g.n_nodes)
