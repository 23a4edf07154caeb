"""GGAD's three-term training objective (counterpart of
``ggad_tpu/train/losses.py``; reference ``run.py:164-210``).

    loss = 1·loss_margin + 1·loss_bce + 1·loss_rec

  * loss_bce — BCE with logits over [normal nodes → 0, generated outliers
    → 1] with ``pos_weight = negsamp_ratio``.
  * loss_margin — the mean affinity of the labeled normals must exceed
    that of the generated outliers by ``confidence_margin = 0.7``.
  * loss_rec — closeness of the generated outliers to the perturbed seed
    embeddings, reduced over the SEED axis as the reference does
    (``losses.py:92-101``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ggad_tpu_torch.models.ggad import GGADOutput
from ggad_tpu_torch.ops.sddmm import node_affinity, node_affinity_at


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Elementwise (1-y)·softplus(x) + w·y·softplus(-x), as
    ``torch.nn.BCEWithLogitsLoss(pos_weight=w)`` without the reduction."""
    return ((1.0 - labels) * F.softplus(logits)
            + pos_weight * labels * F.softplus(-logits))


class GGADLosses(NamedTuple):
    total: torch.Tensor
    bce: torch.Tensor
    margin: torch.Tensor
    rec: torch.Tensor
    affinity_normal: torch.Tensor
    affinity_outlier: torch.Tensor


def ggad_losses(out: GGADOutput, raw_adj, seed_idx: torch.Tensor,
                normal_idx: torch.Tensor, *,
                confidence_margin: float = 0.7, pos_weight: float = 1.0,
                w_margin: float = 1.0, w_bce: float = 1.0,
                w_rec: float = 1.0, aff_sub=None) -> GGADLosses:
    """``aff_sub``: an optional subset over ``[normal_idx ‖ seed_idx]``
    (``ops.sddmm.AffinitySubset`` or ``TileAffinitySubset``); the margin
    then reads the affinity through it, at the same values."""
    n_normal = normal_idx.shape[0]
    n_seed = seed_idx.shape[0]
    dev = out.logits.device
    labels = torch.cat([torch.zeros(n_normal, 1, device=dev),
                        torch.ones(n_seed, 1, device=dev)])
    loss_bce = bce_with_logits(out.logits, labels, pos_weight).mean()

    if aff_sub is not None:
        aff = node_affinity_at(aff_sub, out.emb)
        aff_normal = aff[:n_normal].mean()
        aff_outlier = aff[n_normal:].mean()
    else:
        affinity = node_affinity(raw_adj, out.emb)
        aff_normal = affinity[normal_idx].mean()
        aff_outlier = affinity[seed_idx].mean()
    loss_margin = torch.clamp(
        confidence_margin - (aff_normal - aff_outlier), min=0.0)

    # the reference's emb_abnormal keeps a batch dim, so its sum runs over
    # the seed axis: mean_h sqrt(Σ_s diff²) (losses.py:92-101)
    diff = (out.emb_con - out.emb_abnormal).square()
    loss_rec = diff.sum(0).sqrt().mean()

    total = w_margin * loss_margin + w_bce * loss_bce + w_rec * loss_rec
    return GGADLosses(total, loss_bce, loss_margin, loss_rec,
                      aff_normal, aff_outlier)
