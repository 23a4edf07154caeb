"""AnomalyDAE baseline (counterpart of ``ggad_tpu/models/anomaly_dae.py``).

Reference (``model_AnomalyDAE.py``, ``anomalyDAE.py``):
  * structure branch: Linear(n_in→n_h)+ReLU → GATConv(n_h→n_in);
    s_ = σ(emb embᵀ);
  * attribute branch: 2-layer MLP autoencoder;
  * score_i = α·‖x_i − x̂_i‖₂ + (1−α)·‖a_i − s_i‖₂, α = 0.5;
  * train loss = mean score over the labeled normals.

The structure error is blockwise (``ops.dense_blocks``). The GAT and the
error both read the normalised +I adjacency's edge list (the reference's
``adj``); a ``BCSRGraph`` or ``ELLGraph`` hands over its graph's
``row``/``col``/``val``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.nn.layers import GATLayer, dense
from ggad_tpu_torch.ops.dense_blocks import (
    attr_row_error,
    sigmoid_structure_row_error,
)


class AnomalyDAEOutput(NamedTuple):
    emb: torch.Tensor
    x_rec: torch.Tensor
    scores: torch.Tensor


class AnomalyDAE(nn.Module):
    def __init__(self, n_in: int, n_h: int = 300, alpha: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alpha = alpha
        self.dense_stru = dense(n_in, n_h, generator=generator)
        self.gat = GATLayer(n_h, n_in, generator=generator)
        self.dense_attr_1 = dense(n_in, n_h, generator=generator)
        self.dense_attr_2 = dense(n_h, n_in, generator=generator)

    def forward(self, adj, x: torch.Tensor) -> AnomalyDAEOutput:
        emb = self.gat(adj, torch.relu(self.dense_stru(x)))
        x_rec = self.dense_attr_2(torch.relu(self.dense_attr_1(x)))
        scores = (self.alpha * attr_row_error(x, x_rec)
                  + (1.0 - self.alpha) * sigmoid_structure_row_error(adj,
                                                                     emb))
        return AnomalyDAEOutput(emb, x_rec, scores)


def anomaly_dae_loss(out: AnomalyDAEOutput,
                     train_idx: torch.Tensor) -> torch.Tensor:
    return out.scores[train_idx].mean()
