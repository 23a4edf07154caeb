"""Graph and feature normalization with the reference's exact semantics
(counterpart of ``ggad_tpu/ops/normalize.py``).

The reference's pipeline (``run.py:96-101``):

    adj      = D^{-1/2} A D^{-1/2}      (no self-loops during norm!)
    adj      = adj + I                   (identity added AFTER normalizing)
    raw_adj  = A + I

two feature row-normalizations: ``row_normalize_features`` for the
full-batch path and ``row_normalize_smoothed`` for the minibatch path;
and ``gcn_norm_graph``, PyG's renormalisation of the binarised graph for
the DOMINANT baseline.
"""

from __future__ import annotations

import numpy as np
import torch

from ggad_tpu_torch.graph import Graph, add_self_loops


def sym_normalize(g: Graph) -> Graph:
    """Symmetric normalization Â = D^{-1/2} A D^{-1/2} on the graph's device.

    Degrees are weighted row sums (scipy ``adj.sum(1)``, reference
    ``utils.py:50``). Zero-degree rows get d^{-1/2} = 0, like the
    reference's isinf clamp.
    """
    deg = g.out_degrees()
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg),
                           torch.zeros_like(deg))
    return g.with_val(g.val * inv_sqrt[g.row] * inv_sqrt[g.col])


def normalize_adj_reference(g: Graph) -> tuple[Graph, Graph]:
    """Full reference preprocessing: returns (adj, raw_adj).

      adj     = sym_normalize(A) + I    (reference ``run.py:98-101``)
      raw_adj = A + I
    """
    return add_self_loops(sym_normalize(g)), add_self_loops(g)


def gcn_norm_graph(g: Graph) -> Graph:
    """PyG ``gcn_norm`` semantics (torch_geometric 2.1.0,
    ``normalize.py:64-79``): unit weights over the binarised edges,
    symmetric D^-1/2 B D^-1/2 with in-degrees. The reference's PyG
    baselines (DOMINANT's ``GCN`` stack, ``model_domaint.py:90,168``) hand
    GCNConv the normalised ``adj``'s edges, whose weights it discards. ``g``
    must carry exactly one self-loop per node (the reference's +I graph);
    padding edges (val == 0) stay 0."""
    valid = (g.val != 0).to(g.val.dtype)
    deg = torch.zeros(g.n_nodes, dtype=valid.dtype,
                      device=valid.device).index_add_(0, g.col, valid)
    dinv = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    return g.with_val(valid * dinv[g.row] * dinv[g.col])


def row_normalize_features(x: np.ndarray) -> np.ndarray:
    """D_x^{-1} X row normalization (reference ``utils.py:37-44``).

    Rows with zero sum stay zero. Host-side numpy (runs once at load).
    """
    x = np.asarray(x, dtype=np.float32)
    rowsum = x.sum(axis=1)
    inv = np.where(rowsum != 0, 1.0 / rowsum, 0.0)
    return x * inv[:, None]


def row_normalize_smoothed(x: np.ndarray) -> np.ndarray:
    """The minibatch path's feature normalization (reference
    ``src/utils.py:74-84``): x / (rowsum + 0.01), the +0.01 smoothing
    distinct from :func:`row_normalize_features`. The reference's
    ModelHandler applies it to every dataset (``src/model_handler.py:225``).
    """
    x = np.asarray(x, dtype=np.float32)
    rowsum = x.sum(axis=1) + 0.01
    inv = np.where(np.isfinite(1.0 / rowsum), 1.0 / rowsum, 0.0)
    return x * inv[:, None]
