"""Minibatch GGAD and the supervised GraphSAGE baseline over sampled
neighborhoods, the DGraph-scale path (counterpart of
``ggad_tpu/models/sage.py``).

  * A device-resident :class:`~ggad_tpu_torch.sampler.NeighborTable`
    feeds fixed-fanout sampled gathers with static ``[B, K]`` shapes.
  * ``agg="gcn"`` weighs each mean over sampled neighbors by
    ``sqrt(deg)``, JAX's deterministic stand-in for the reference's
    batch-local ``mask / sqrt(rowsum) / sqrt(colsum)``; ``"mean"`` is the
    plain mean.
  * The train branch's two-hop expansion is a bounded K1×K2 sample; the
    anomaly (seed) slots sit at the end of each batch with a static count.

The semantics are the reference's (``src/graphsage.py:157-272,363-454``):
outlier generation from two-hop aggregates through a ReLU fc, a scalar
one-class scorer, and BCE + cosine-affinity margin (margin 1) +
0.1·egocentric closeness.

The parameters keep flax's names and layouts: ``w_enc`` ``[F, emb]``,
``w_score`` ``[emb, 1]`` and ``fc_gen`` a :class:`DenseNoBias` (and
:class:`GraphSAGEClassifier`'s ``w_enc`` ``[2F, emb]``, ``w_cls``
``[emb, 2]``), so ``interop.params_from_flax`` carries JAX's weights over
unchanged. The uniform draws of the sampler are arguments (``u``, ``u1``,
``u2``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.nn.layers import DenseNoBias
from ggad_tpu_torch.sampler.neighbor import (
    NeighborTable,
    sample_neighbors,
    sample_two_hop,
)
from ggad_tpu_torch.train.losses import bce_with_logits


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm, floored at 1e-8."""
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                axis: int) -> torch.Tensor:
    num = (x * mask.unsqueeze(-1)).sum(axis)
    den = mask.sum(axis).clamp(min=1.0)
    return num / den.unsqueeze(-1)


def gather_rows(feats: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``feats[ids]`` for an id tensor of any shape: ``[*ids.shape, F]``."""
    return feats.index_select(0, ids.reshape(-1)).view(*ids.shape, -1)


def xavier_param(shape: tuple[int, int],
            generator: Optional[torch.Generator]) -> nn.Parameter:
    """Xavier-uniform ``[in, out]``, flax's ``xavier_uniform`` layout."""
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, dtype=torch.float32)
    return nn.Parameter(w.uniform_(-bound, bound, generator=generator))


class MiniBatchGGADOutput(NamedTuple):
    combined_all: torch.Tensor      # [B, emb] final embeddings (the anomaly
                                    # slots hold the generated outliers in
                                    # the train branch)
    scores: torch.Tensor            # [B] one-class logits
    context: torch.Tensor           # [B, emb] 2-hop affinity context
    anomaly_feat: torch.Tensor      # [S, emb] encoder embedding of seeds
    anomaly_feat_new: torch.Tensor  # [S, emb] generated outliers


class MiniBatchGGAD(nn.Module):
    """GGAD over sampled neighborhoods (the reference's GCN aggregator,
    GCNEncoder and GCN scorer in one module)."""

    def __init__(self, feat_dim: int, emb_dim: int = 64, fanout1: int = 16,
                 fanout2: int = 8, agg: str = "gcn", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if agg not in ("gcn", "mean"):
            raise ValueError(f"agg must be 'gcn' or 'mean', got {agg!r}")
        self.emb_dim, self.fanout1, self.fanout2 = emb_dim, fanout1, fanout2
        self.agg = agg
        self.w_enc = xavier_param((feat_dim, emb_dim), generator)
        self.w_score = xavier_param((emb_dim, 1), generator)
        self.fc_gen = DenseNoBias(emb_dim, emb_dim, generator=generator)

    def _agg_weight(self, table: NeighborTable,
                    nodes: torch.Tensor) -> torch.Tensor:
        if self.agg == "gcn":
            deg = table.degrees_of(nodes).float()
            return deg.clamp(min=1.0).sqrt()
        return torch.ones(nodes.shape, device=nodes.device)

    def forward(self, feats: torch.Tensor, table: NeighborTable,
                batch: torch.Tensor, n_anom: int, train: bool = True, *,
                u1: torch.Tensor, u2: Optional[torch.Tensor] = None,
                anom: Optional[torch.Tensor] = None) -> MiniBatchGGADOutput:
        """``batch``: [B] int32 node ids, the last ``n_anom`` the anomaly
        slots; ``feats``: [N, F] frozen features. ``u1`` [B, K1] draws the
        first hop; ``u2`` [B·K1, K2] the second (train branch only).
        ``anom`` [B] bool, in place of ``n_anom``, marks the anomaly slots
        row by row (a data-parallel shard's slice of the batch,
        ``parallel.minibatch_dp``): the generator then runs on every row,
        ``combined_all`` takes its output where ``anom`` is set, and
        ``anomaly_feat`` / ``anomaly_feat_new`` are ``[B, emb]``."""
        b = batch.shape[0]
        if train:
            n1, m1, n2, m2 = sample_two_hop(table, batch, self.fanout1,
                                            self.fanout2, u1, u2)
        else:
            n1, m1 = sample_neighbors(table, batch, self.fanout1, u1)

        # 1-hop aggregate of each batch node (the table has self-loops, so
        # the node itself takes part, like the reference's union)
        x1 = gather_rows(feats, n1)
        agg_b = masked_mean(x1, m1, 1) * self._agg_weight(table,
                                                          batch)[:, None]
        combined = torch.relu(agg_b @ self.w_enc)           # [B, emb]

        if not train:
            zeros = combined.new_zeros(n_anom, self.emb_dim)
            return MiniBatchGGADOutput(combined, (combined @ self.w_score)[:, 0],
                                       torch.zeros_like(combined), zeros,
                                       zeros)

        # 2-hop: encode each sampled neighbor from ITS neighbors, then
        # mean those encodings per batch node: the affinity context
        # (reference src/graphsage.py:419-421)
        x2 = gather_rows(feats, n2)
        agg_n1 = masked_mean(x2, m2, 2) * self._agg_weight(table,
                                                           n1)[..., None]
        combined_expand = torch.relu(agg_n1 @ self.w_enc)   # [B, K1, emb]
        context = masked_mean(combined_expand, m1, 1)       # [B, emb]

        # outliers generated from the anomaly slots' 2-hop context
        # (reference src/graphsage.py:427-430)
        if anom is not None:
            gen = torch.relu(self.fc_gen(context))
            combined_all = torch.where(anom[:, None], gen, combined)
            return MiniBatchGGADOutput(combined_all,
                                       (combined_all @ self.w_score)[:, 0],
                                       context, combined, gen)
        anomaly_feat = combined[b - n_anom:]
        anomaly_feat_new = torch.relu(self.fc_gen(context[b - n_anom:]))
        combined_all = torch.cat([combined[: b - n_anom], anomaly_feat_new])
        scores = (combined_all @ self.w_score)[:, 0]
        return MiniBatchGGADOutput(combined_all, scores, context,
                                   anomaly_feat, anomaly_feat_new)


class MiniBatchGGADLosses(NamedTuple):
    total: torch.Tensor
    cls: torch.Tensor
    constraint: torch.Tensor
    rec: torch.Tensor


def minibatch_ggad_losses(out: MiniBatchGGADOutput, n_anom: int, *,
                          confidence_margin: float = 1.0,
                          w_rec: float = 0.1) -> MiniBatchGGADLosses:
    """1·BCE + 1·affinity margin (cosine, margin 1) + 0.1·ego closeness
    (reference ``src/graphsage.py:244-258``)."""
    b = out.scores.shape[0]
    dev = out.scores.device
    labels = torch.cat([torch.zeros(b - n_anom, device=dev),
                        torch.ones(n_anom, device=dev)])
    loss_cls = bce_with_logits(out.scores, labels).mean()

    aff = (l2_normalize(out.combined_all)
           * l2_normalize(out.context)).sum(-1)
    aff_norm = aff[: b - n_anom].mean()
    aff_anom = aff[b - n_anom:].mean()
    loss_constraint = torch.clamp(
        confidence_margin - (aff_norm - aff_anom), min=0.0)

    diff = (out.anomaly_feat - out.anomaly_feat_new).square()
    loss_rec = diff.sum(1).sqrt().mean()

    total = loss_cls + loss_constraint + w_rec * loss_rec
    return MiniBatchGGADLosses(total, loss_cls, loss_constraint, loss_rec)


class GraphSAGEClassifier(nn.Module):
    """The supervised GraphSAGE baseline (reference
    ``src/graphsage.py:19-43,102-154``): concat(self, mean of ``fanout``
    sampled neighbors) → ReLU(·``w_enc``) → class logits (·``w_cls``),
    trained with cross-entropy."""

    def __init__(self, feat_dim: int, emb_dim: int = 64, fanout: int = 5,
                 num_classes: int = 2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanout = fanout
        self.w_enc = xavier_param((2 * feat_dim, emb_dim), generator)
        self.w_cls = xavier_param((emb_dim, num_classes), generator)

    def forward(self, feats: torch.Tensor, table: NeighborTable,
                batch: torch.Tensor, *, u: torch.Tensor) -> torch.Tensor:
        """``[B, num_classes]`` logits of ``batch`` ([B] int32); ``u``
        [B, fanout] draws the neighbors."""
        n1, m1 = sample_neighbors(table, batch, self.fanout, u)
        combined = torch.cat([feats.index_select(0, batch),
                              masked_mean(gather_rows(feats, n1), m1, 1)],
                             dim=-1)
        return torch.relu(combined @ self.w_enc) @ self.w_cls
