"""GGAD (counterpart of ``ggad_tpu/models/ggad.py``).

  * 2-layer GCN encoder (n_in → n_h → n_h, PReLU) over a sparse Â;
    gcn1 runs on the hoisted ``Â·x`` when given, gcn2's Â·(hW₂) goes
    through ``ops.spmm`` (the BCSR kernel on a tile-dense graph, the ELL
    sigma tables on a tile-sparse one).
  * Outlier generation (train branch): for each seed node s,
      - target    emb_abnormal[s] = emb[s] + noise[s]  (``model.py:141-144``)
      - generated emb_con[s] = ReLU(fc4((Â @ emb)[s]))  (``model.py:151-156``)
  * One-class MLP head: scores [emb[normal] ‖ emb_con] in training, every
    node in eval (higher = more anomalous).
  * In training the seed rows of the returned embedding are replaced by
    the generated outliers (the reference's in-place write,
    ``model.py:182``).

``jax.random`` cannot be reproduced in torch, so the noise is an argument:
the trainer draws it from its own generator, a test passes JAX's draw. The
eval branch draws none (JAX's eval noise never reaches the logits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.nn.layers import DenseNoBias, GCNLayer, MLPHead
from ggad_tpu_torch.ops.spmm import spmm


def replace_rows(emb: torch.Tensor, values: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """out = emb with out[rows[k]] = values[k] (``rows`` unique). The
    backward is the exact transpose of ``ggad.py:36-81``: the replaced
    rows' cotangent is zeroed and gathered into ``values``. (JAX's FMA
    form differs from this exact copy by ≤ 1 ulp on replaced rows.)"""
    return emb.index_copy(0, rows, values)


class GGADOutput(NamedTuple):
    emb: torch.Tensor                      # [N, n_h]; seed rows replaced (train)
    emb_combine: Optional[torch.Tensor]    # [Nn+S, n_h] head input (train)
    logits: torch.Tensor                   # [Nn+S, 1] (train) / [N, 1] (eval)
    emb_con: Optional[torch.Tensor]        # [S, n_h] generated outliers (train)
    emb_abnormal: Optional[torch.Tensor]   # [S, n_h] perturbed seeds


class GGAD(nn.Module):
    """Flagship model. ``n_h`` defaults to the reference's 300."""

    def __init__(self, n_in: int, n_h: int = 300, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_h = n_h
        self.gcn1 = GCNLayer(n_in, n_h, generator=generator)
        self.gcn2 = GCNLayer(n_h, n_h, generator=generator)
        self.head = MLPHead(n_h, (n_h // 2, n_h // 4), 1,
                            generator=generator)
        self.fc4 = DenseNoBias(n_h, n_h, generator=generator)

    def encode(self, adj, x: torch.Tensor,
               ax: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.gcn2(adj, self.gcn1(adj, x, pre_agg=ax))

    def forward(self, adj, x: torch.Tensor,
                seed_idx: Optional[torch.Tensor] = None,
                normal_idx: Optional[torch.Tensor] = None, *,
                train: bool = False, seed_adj=None,
                ax: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> GGADOutput:
        """``ggad.py:131-171``. ``ax``: optional precomputed ``Â @ x``,
        which hoists the first layer's aggregation. In training,
        ``seed_adj`` is the optional row-subgraph of ``adj`` at
        ``seed_idx`` (``graph.rows_subgraph``, or its ``ELLGraph`` with
        rectangular sigma tables on the ELL route; the aggregation then
        costs O(E_seed) through ``ops.spmm``) and ``noise`` the
        ``[S, n_h]`` draw added to the seed embeddings."""
        emb = self.encode(adj, x, ax=ax)
        if not train:
            return GGADOutput(emb, None, self.head(emb), None, None)
        if seed_idx is None or normal_idx is None or noise is None:
            raise ValueError("the train branch needs seed_idx, normal_idx "
                             "and noise")
        emb_abnormal = emb[seed_idx] + noise
        if seed_adj is not None:
            agg = spmm(seed_adj, emb)
        else:
            agg = spmm(adj, emb)[seed_idx]
        emb_con = torch.relu(self.fc4(agg))
        emb_combine = torch.cat([emb[normal_idx], emb_con], dim=0)
        logits = self.head(emb_combine)
        emb = replace_rows(emb, emb_con, seed_idx)
        return GGADOutput(emb, emb_combine, logits, emb_con, emb_abnormal)
