"""DOMINANT baseline (counterpart of ``ggad_tpu/models/dominant.py``).

Reference (``model_domaint.py``, ``dominant.py``): a structure branch
(Linear→ReLU→PyG 2-layer ``GCN`` back to n_in, ReLU between the convs
only) whose output the reference computes and never reads (its structure
term is commented out, ``model_domaint.py:113-125``), and an attribute MLP
autoencoder (dense_attr_1→ReLU→dense_attr_2) whose per-row L2 error is
both the training loss (over the labeled normals) and the anomaly score.

At ``structure_weight = 1.0`` (the reference's default: attribute only)
nothing reads the structure branch. JAX's jitted step drops it; the port
does not compute it, so ``DominantOutput.emb`` is None and
:meth:`Dominant.embed` gives the branch to whoever asks. Below 1.0 the
blockwise structure error joins the score. For PyG parity the branch runs
on ``gcn_norm_graph`` of the +I graph (``train.baselines`` passes it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.nn.layers import GCNLayer, dense
from ggad_tpu_torch.ops.dense_blocks import (
    attr_row_error,
    sigmoid_structure_row_error,
)


class DominantOutput(NamedTuple):
    emb: Optional[torch.Tensor]   # structure branch [N, n_in], when read
    x_rec: torch.Tensor           # attribute reconstruction [N, n_in]
    scores: torch.Tensor          # per-node anomaly scores [N]


class Dominant(nn.Module):
    def __init__(self, n_in: int, n_h: int = 300,
                 structure_weight: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.structure_weight = structure_weight
        self.dense_stru = dense(n_in, n_h, generator=generator)
        self.gcn1 = GCNLayer(n_h, n_in, act="relu", generator=generator)
        self.gcn2 = GCNLayer(n_in, n_in, act="none", generator=generator)
        self.dense_attr_1 = dense(n_in, n_h, generator=generator)
        self.dense_attr_2 = dense(n_h, n_in, generator=generator)

    def embed(self, g, x: torch.Tensor) -> torch.Tensor:
        """The structure branch on ``g`` (the gcn_norm graph for PyG
        parity)."""
        h = torch.relu(self.dense_stru(x))
        return self.gcn2(g, self.gcn1(g, h))

    def forward(self, adj, x: torch.Tensor,
                gcn_adj=None) -> DominantOutput:
        x_rec = self.dense_attr_2(torch.relu(self.dense_attr_1(x)))
        score = self.structure_weight * attr_row_error(x, x_rec)
        emb = None
        if self.structure_weight < 1.0:
            emb = self.embed(gcn_adj if gcn_adj is not None else adj, x)
            score = score + (1.0 - self.structure_weight) * \
                sigmoid_structure_row_error(adj, emb)
        return DominantOutput(emb, x_rec, score)


def dominant_loss(out: DominantOutput,
                  train_idx: torch.Tensor) -> torch.Tensor:
    """Mean score over the labeled normals (reference ``dominant.py:138``)."""
    return out.scores[train_idx].mean()
