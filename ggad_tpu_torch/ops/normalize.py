"""Graph and feature normalization with the reference's exact semantics
(counterpart of ``ggad_tpu/ops/normalize.py``).

The reference's pipeline (``run.py:96-101``):

    adj      = D^{-1/2} A D^{-1/2}      (no self-loops during norm!)
    adj      = adj + I                   (identity added AFTER normalizing)
    raw_adj  = A + I
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


def row_normalize_features(x: np.ndarray) -> np.ndarray:
    """D_x^{-1} X row normalization (reference ``utils.py:37-44``).

    Rows with zero sum stay zero. Host-side numpy (runs once at load).
    """
    x = np.asarray(x, dtype=np.float32)
    rowsum = x.sum(axis=1)
    inv = np.where(rowsum != 0, 1.0 / rowsum, 0.0)
    return x * inv[:, None]
