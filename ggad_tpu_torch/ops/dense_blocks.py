"""Blockwise all-pairs reductions: the structure-reconstruction errors
(counterpart of ``ggad_tpu/ops/dense_blocks.py``).

AnomalyDAE scores a node by the row error of σ(E Eᵀ) against the dense
adjacency (reference ``model_AnomalyDAE.py:252-267, 289-301``). The
reference materialises the N×N matrix; here

    stru_err_i = sqrt( Σ_j σ(e_i·e_j)²  −  2·Σ_{j∈N(i)} a_ij σ(e_i·e_j)
                       + Σ_j a_ij² )

takes its all-pairs term from column panels of ``block`` nodes and its
adjacency terms from the edge list, so no N×N tensor is ever resident.
Each panel is a ``torch.utils.checkpoint`` region: the backward recomputes
the ``[N, block]`` similarities instead of keeping every panel (8.7 GB at
the elliptic shape), as JAX's ``jax.checkpoint`` does. The panel product is
a dense f32 matmul, which JAX also takes outside any Pallas kernel; it is
true f32 as long as TF32 stays off (PyTorch's default), as JAX's
``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _panel(emb: torch.Tensor, e_blk: torch.Tensor, mask: torch.Tensor,
           fn: Callable) -> torch.Tensor:
    s = emb @ e_blk.t()
    return torch.where(mask[None, :], fn(s), 0.0).sum(dim=1)


def blockwise_pair_reduce(emb: torch.Tensor, fn: Callable,
                          block: int = 1024) -> torch.Tensor:
    """r_i = Σ_j fn(e_i · e_j), over column blocks of ``block`` nodes; the
    last block is zero-padded and its padding columns masked, as in
    JAX."""
    n, _ = emb.shape
    n_pad = _round_up(n, block)
    embp = F.pad(emb, (0, 0, 0, n_pad - n))
    cols = torch.arange(block, device=emb.device)
    acc = torch.zeros(n, dtype=emb.dtype, device=emb.device)
    for start in range(0, n_pad, block):
        acc = acc + checkpoint(_panel, emb, embp[start:start + block],
                               (start + cols) < n, fn, use_reentrant=False)
    return acc


def _sigmoid_sq(s: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.sigmoid(s))


def sigmoid_structure_row_error(g, emb: torch.Tensor,
                                block: int = 1024) -> torch.Tensor:
    """Per-row L2 error between A (``g``'s edges, weights included, padding
    edges carrying 0) and σ(emb embᵀ): the AnomalyDAE structure term."""
    term1 = blockwise_pair_reduce(emb, _sigmoid_sq, block=block)
    edge_sig = torch.sigmoid((emb[g.row] * emb[g.col]).sum(dim=1))
    zeros = torch.zeros(g.n_nodes, dtype=emb.dtype, device=emb.device)
    cross = zeros.index_add(0, g.row, edge_sig * g.val)
    a_sq = zeros.index_add(0, g.row, torch.square(g.val))
    return torch.sqrt(torch.clamp_min(term1 - 2.0 * cross + a_sq, 0.0))


def attr_row_error(x: torch.Tensor, x_rec: torch.Tensor) -> torch.Tensor:
    """Per-row L2 attribute reconstruction error (reference
    ``double_recon_loss`` attr term, ``model_AnomalyDAE.py:203-213``)."""
    return torch.sqrt(torch.square(x - x_rec).sum(dim=1))
