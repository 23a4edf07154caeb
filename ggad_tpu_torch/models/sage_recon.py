"""Minibatch reconstruction and adversarial baselines over sampled
neighborhoods (counterpart of ``ggad_tpu/models/sage_recon.py``).

Sampled-neighborhood DOMINANT, AnomalyDAE and AEGIS for the DGraph-scale
path (reference ``src/graphsage_dominant.py``,
``src/graphsage_anomalydae.py``, ``src/graphsage_aegis.py``): the
sqrt(deg)·mean aggregation of :class:`~ggad_tpu_torch.models.sage.
MiniBatchGGAD`, an encoder ReLU(·``w_enc``), and

  * DOMINANT-mb: a feature decoder ReLU(``fc_dec``); the training loss is
    mean_f sqrt(Σ_batch (x − x̂)²): the reference sums over the *batch*
    axis (``src/graphsage_dominant.py:157-158``), kept; the score is each
    node's reconstruction error (``src/utils.py:159-160``);
  * AnomalyDAE-mb: the same with the reference's "positive weighting",
    which multiplies both branches by 0.5 and so halves the loss
    (``src/graphsage_anomalydae.py:155-163``), kept;
  * AEGIS-mb: a fixed ``[N, F]`` noise table aggregated with the same
    sample, encoded by the same weights; a PyG-MLP discriminator
    separates real (0) from noise (1); the score is its output on the
    real embedding (``src/graphsage_aegis.py:280-323``).

The draws of the sampler (``u`` [B, fanout]) and AEGIS's noise table are
arguments. The parameters keep flax's names (``w_enc`` ``[F, emb]``,
``fc_dec``, ``discriminator2``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.models.aegis import PyGMLP
from ggad_tpu_torch.models.sage import gather_rows, masked_mean, xavier_param
from ggad_tpu_torch.nn.layers import DenseNoBias
from ggad_tpu_torch.ops.bce import bce_probs
from ggad_tpu_torch.sampler.neighbor import NeighborTable, sample_neighbors


def _gcn_aggregate(feats: torch.Tensor, table: NeighborTable,
                   batch: torch.Tensor, fanout: int,
                   u: torch.Tensor) -> torch.Tensor:
    """sqrt(max(deg, 1)) · the mean of ``fanout`` sampled neighbors."""
    n1, m1 = sample_neighbors(table, batch, fanout, u)
    deg = table.degrees_of(batch).float()
    return masked_mean(gather_rows(feats, n1), m1, 1) \
        * deg.clamp(min=1.0).sqrt()[:, None]


class MiniBatchRecon(nn.Module):
    """DOMINANT-mb (``pos_weighted=False``) and AnomalyDAE-mb."""

    def __init__(self, feat_dim: int, emb_dim: int = 64, fanout: int = 16,
                 pos_weighted: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanout, self.pos_weighted = fanout, pos_weighted
        self.w_enc = xavier_param((feat_dim, emb_dim), generator)
        self.fc_dec = DenseNoBias(emb_dim, feat_dim, generator=generator)

    def forward(self, feats: torch.Tensor, table: NeighborTable,
                batch: torch.Tensor, *, u: torch.Tensor) -> torch.Tensor:
        """The reconstructed features ``[B, F]`` of ``batch``."""
        agg = _gcn_aggregate(feats, table, batch, self.fanout, u)
        return torch.relu(self.fc_dec(torch.relu(agg @ self.w_enc)))

    def train_loss(self, x_rec: torch.Tensor,
                   x_batch: torch.Tensor) -> torch.Tensor:
        diff = (x_batch - x_rec).square()
        if self.pos_weighted:     # both branches × 0.5, as the reference
            diff = diff * 0.5
        # the reference sums over the BATCH axis, then means over features
        return diff.sum(0).sqrt().mean()

    @staticmethod
    def scores(x_rec: torch.Tensor, x_batch: torch.Tensor) -> torch.Tensor:
        return (x_batch - x_rec).square().sum(1).sqrt()


class AEGISMbOutput(NamedTuple):
    probs_all: torch.Tensor   # [2B] sigmoid(disc(cat([z, z_noise]))), its
    #                           BN statistics over the 2B rows
    prob_noise: torch.Tensor  # [B] sigmoid(disc(z_noise)), a forward of
    #                           its own

    @property
    def prob_real(self) -> torch.Tensor:
        """The real half's fake-probabilities: the anomaly score
        (``src/utils.py:175-204``)."""
        return self.probs_all[: self.prob_noise.shape[0]]


class MiniBatchAEGIS(nn.Module):
    """The reference's PyG-MLP discriminator (train-mode BatchNorm): the
    discriminator loss and the scores read ``disc(cat([z, z_noise]))``,
    the generator loss a separate ``disc(z_noise)``; the sigmoid sits on
    top of the MLP's own sigmoid activation; nothing is detached: one
    optimizer takes both losses through encoder and discriminator
    (``src/graphsage_aegis.py:315-321``,
    ``src/model_handler_aegis.py:159-161``)."""

    def __init__(self, feat_dim: int, emb_dim: int = 64, fanout: int = 16,
                 hid_dim: int = 64, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanout = fanout
        self.w_enc = xavier_param((feat_dim, emb_dim), generator)
        self.discriminator2 = PyGMLP(emb_dim, hid_dim, 1, act="sigmoid",
                                     generator=generator)

    def forward(self, feats: torch.Tensor, noise_table: torch.Tensor,
                table: NeighborTable, batch: torch.Tensor, *,
                u: torch.Tensor) -> AEGISMbOutput:
        """``noise_table`` [N, F]; ``u`` [B, fanout] draws one sample that
        the real and the noise aggregates share."""
        n1, m1 = sample_neighbors(table, batch, self.fanout, u)
        deg = table.degrees_of(batch).float().clamp(min=1.0).sqrt()[:, None]
        agg_real = masked_mean(gather_rows(feats, n1), m1, 1) * deg
        agg_noise = masked_mean(gather_rows(noise_table, n1), m1, 1) * deg
        z = torch.relu(agg_real @ self.w_enc)
        z_noise = torch.relu(agg_noise @ self.w_enc)
        disc = self.discriminator2
        probs_all = torch.sigmoid(disc(torch.cat([z, z_noise])))[:, 0]
        prob_noise = torch.sigmoid(disc(z_noise))[:, 0]
        return AEGISMbOutput(probs_all, prob_noise)


def aegis_mb_losses(out: AEGISMbOutput):
    """(loss_dis, loss_g): BCE(disc(cat), [0…0, 1…1]) and BCE(disc(z_noise),
    0), torch's ``F.binary_cross_entropy`` (``src/graphsage_aegis.py:
    168-172``), neither detached."""
    b = out.prob_noise.shape[0]
    dev = out.probs_all.device
    labels = torch.cat([torch.zeros(b, device=dev),
                        torch.ones(b, device=dev)])
    loss_dis = bce_probs(out.probs_all, labels).mean()
    loss_g = bce_probs(out.prob_noise, 0.0).mean()
    return loss_dis, loss_g
