"""PC-GNN-style multi-relation classifier with GGAD's affinity margin
(counterpart of ``ggad_tpu/models/pcgnn.py``).

Reference (``src/layers.py``, ``src/model.py``, "Pick and Choose"
adapted): per relation r, the mean of sampled neighbor features →
ReLU(·``w_r``), and a two-hop context; the relations concatenate and pass
a shared transform ``w_inter``; the loss is cross-entropy on a two-class
head plus 5× the cosine-affinity margin (margin 1) between the final
embedding and its context (``src/model.py:34-47``). The reference's
label-aware neighbor filtering is dead code there and is not carried.

Each relation samples its own two hops from its own draws: JAX splits the
``sample`` key once a relation (``pcgnn.py:59-62``), so :class:`PCGNN`
takes one ``(u1, u2)`` pair a relation. A homogeneous graph passes one
:class:`NeighborTable` for every relation. The parameters keep flax's
names and ``[in, out]`` layouts (``w_inter``, ``w_cls``, ``w_r0``…).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ggad_tpu_torch.models.sage import gather_rows, masked_mean, xavier_param
from ggad_tpu_torch.sampler.neighbor import NeighborTable, sample_two_hop


class PCGNNOutput(NamedTuple):
    embeds: torch.Tensor    # [B, emb]
    affinity: torch.Tensor  # [B]
    scores: torch.Tensor    # [B, num_classes]


def _l2n(v: torch.Tensor) -> torch.Tensor:
    """Unit rows, zero rows kept zero (``pcgnn.py:79-81``: eps 1e-12, not
    ``sage.py``'s 1e-8)."""
    n = v.norm(dim=-1, keepdim=True)
    return torch.where(n > 0, v / n.clamp(min=1e-12), 0.0)


class PCGNN(nn.Module):
    def __init__(self, feat_dim: int, emb_dim: int = 64,
                 n_relations: int = 3, fanout1: int = 16, fanout2: int = 8,
                 num_classes: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_relations = n_relations
        self.fanout1, self.fanout2 = fanout1, fanout2
        self.w_inter = xavier_param((emb_dim * n_relations, emb_dim),
                                    generator)
        self.w_cls = xavier_param((emb_dim, num_classes), generator)
        for r in range(n_relations):
            self.register_parameter(
                f"w_r{r}", xavier_param((feat_dim, emb_dim), generator))

    def forward(self, feats: torch.Tensor,
                tables: Sequence[NeighborTable], batch: torch.Tensor, *,
                draws: Sequence[tuple[torch.Tensor, torch.Tensor]]
                ) -> PCGNNOutput:
        """``draws[r]`` = (u1 [B, K1], u2 [B·K1, K2]) samples relation r's
        two hops."""
        if len(tables) != self.n_relations or len(draws) != len(tables):
            raise ValueError(f"{self.n_relations} relations, got "
                             f"{len(tables)} tables and {len(draws)} draws")
        r_feats, r_ctx = [], []
        for r, (table, (u1, u2)) in enumerate(zip(tables, draws)):
            w_r = getattr(self, f"w_r{r}")
            n1, m1, n2, m2 = sample_two_hop(table, batch, self.fanout1,
                                            self.fanout2, u1, u2)
            # intra: the mean of the 1-hop features (IntraAgg mask.div)
            agg = masked_mean(gather_rows(feats, n1), m1, 1)
            r_feats.append(torch.relu(agg @ w_r))
            # 2-hop context, weighted by sqrt of each sampled n1's degree
            deg1 = table.degrees_of(n1).float()
            agg2 = masked_mean(gather_rows(feats, n2), m2, 2) \
                * deg1.clamp(min=1.0).sqrt()[..., None]
            ctx_r = torch.relu(agg2 @ w_r)                  # [B, K1, emb]
            r_ctx.append(masked_mean(ctx_r, m1, 1))
        embeds = torch.relu(torch.cat(r_feats, dim=-1) @ self.w_inter)
        ctx = torch.relu(torch.cat(r_ctx, dim=-1) @ self.w_inter)
        affinity = (_l2n(ctx) * _l2n(embeds)).sum(-1)
        return PCGNNOutput(embeds, affinity, embeds @ self.w_cls)


def pcgnn_loss(out: PCGNNOutput, labels: torch.Tensor, *,
               lambda_constraint: float = 5.0,
               confidence_margin: float = 1.0):
    """(total, cross-entropy, margin): CE + λ·affinity margin (reference
    ``src/model.py:42-47``). ``labels``: [B] int {0, 1}."""
    loss_cls = F.cross_entropy(out.scores, labels.long())
    is_anom = labels == 1
    n_anom = is_anom.sum().clamp(min=1)
    n_norm = (~is_anom).sum().clamp(min=1)
    aff_norm = torch.where(~is_anom, out.affinity, 0.0).sum() / n_norm
    aff_anom = torch.where(is_anom, out.affinity, 0.0).sum() / n_anom
    loss_margin = torch.clamp(
        confidence_margin - (aff_norm - aff_anom), min=0.0)
    return loss_cls + lambda_constraint * loss_margin, loss_cls, loss_margin


def pcgnn_prob(out: PCGNNOutput) -> torch.Tensor:
    """Anomaly probability: sigmoid of the class-1 logit (reference
    ``PCALayer.to_prob``)."""
    return torch.sigmoid(out.scores[:, 1])
