"""Sparse matrix × dense matrix (SpMM): out[r] = Σ_e val[e] · X[col[e]]
(counterpart of ``ggad_tpu/ops/spmm.py``).

The COO path is gather + ``index_add_`` (O(E·d)); a graph that carries
BCSR tiles (:class:`~ggad_tpu_torch.ops.bcsr_spmm.BCSRGraph`) goes through
the hand-written block-sparse kernel instead, and one that carries ELL
tables (:class:`~ggad_tpu_torch.ops.ell_spmm.ELLGraph`) through their
bucketed gathers. Every route runs under the ``spmm`` span
(``utils.tracing``); the backward of the tile and table products opens
its own.
"""

from __future__ import annotations

import torch

from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm
from ggad_tpu_torch.ops.ell_spmm import ELLGraph, ell_spmm
from ggad_tpu_torch.utils.tracing import span

SPMM_OP_IMPLS = ("auto", "coo", "xla", "bcsr", "pallas")


def spmm_coo(row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """COO SpMM via gather + ``index_add_``. Padding edges must have
    val == 0 (their gathered row contributes 0)."""
    out = torch.zeros(n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, row, x[col] * val[:, None])


def spmm(g, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Compute A @ x for the sparse adjacency held by ``g``.

    Dispatch on the graph type, as ``ggad_tpu.ops.spmm.spmm`` does: a
    BCSRGraph runs the BCSR kernel and an ELLGraph ``ell_spmm`` unless
    ``impl='coo'`` forces the gather path. JAX's names are aliases:
    ``'xla'`` of ``'coo'``, ``'pallas'`` of ``'bcsr'``, which on a graph
    without tiles raises JAX's guidance (``pallas_spmm.py:408-413``).
    """
    if impl not in SPMM_OP_IMPLS:
        raise ValueError(f"unknown spmm impl {impl!r}")
    gather = impl in ("coo", "xla")
    with span("spmm"):
        if isinstance(g, BCSRGraph) and not gather:
            return bcsr_spmm(g.tiles, x)
        if isinstance(g, ELLGraph) and not gather:
            return ell_spmm(g.tables, x)
        if impl in ("bcsr", "pallas"):
            raise TypeError(f"spmm(impl={impl!r}) needs a BCSRGraph (see "
                            f"as_bcsr_graph); got {type(g).__name__}")
        return spmm_coo(g.row, g.col, g.val, x, g.n_nodes)
