"""AEGIS baseline, a GCN autoencoder with a GAN on its embeddings
(counterpart of ``ggad_tpu/models/aegis.py``).

Reference (``model_AEGIS.py:126-240``, ``aegis.py:96-140``):
  * GCN autoencoder: enc (n_in→n_h→n_h), dec (n_h→n_h→n_in); AE loss =
    per-row L2 reconstruction error over the training ids;
  * PyG-``MLP`` generator: noise(16)→64→n_in fake features, encoded by the
    same GCN encoder → z_gen;
  * PyG-``MLP`` discriminator2 (n_h→64→1, sigmoid hidden activation)
    separates real (0) from generated (1) embeddings;
  * anomaly score = sigmoid(discriminator2(z)) read from the concatenated
    forward.

PyG 2.1.0's ``MLP`` has a train-mode BatchNorm1d between the hidden Linear
and its activation (:class:`PyGMLP`), so the discriminator's outputs
depend on the batch: ``probs_all`` takes its statistics over the 2N rows
of ``cat([z, z_gen])`` (scores and the discriminator loss read it),
``prob_gen`` over the N generated rows (the generator loss reads it),
``model_AEGIS.py:215-220``. The training phases and the reference's
effective behaviour (``faithful``) are in ``train.baselines.run_aegis``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ggad_tpu_torch.nn.layers import GCNLayer, dense
from ggad_tpu_torch.ops.bce import bce_probs
from ggad_tpu_torch.ops.dense_blocks import attr_row_error


class PyGMLP(nn.Module):
    """2-layer MLP with torch_geometric 2.1.0 ``MLP`` semantics: Linear →
    BatchNorm1d → act → Linear. The BatchNorm uses the statistics of the
    current input (biased variance, eps 1e-5) and keeps no running
    statistics: the reference never scores in eval mode. Parameters are
    named as flax's: ``lin1``, ``bn_scale``, ``bn_bias``, ``lin2``."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 act: str = "relu", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in ("relu", "sigmoid"):
            raise ValueError(f"unknown act {act!r}")
        self.act = act
        self.lin1 = dense(in_features, hidden, generator=generator)
        self.bn_scale = nn.Parameter(torch.ones(hidden))
        self.bn_bias = nn.Parameter(torch.zeros(hidden))
        self.lin2 = dense(hidden, out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.batch_norm(self.lin1(x), None, None, self.bn_scale,
                         self.bn_bias, training=True, eps=1e-5)
        h = torch.relu(h) if self.act == "relu" else torch.sigmoid(h)
        return self.lin2(h)


class AEGISOutput(NamedTuple):
    z: torch.Tensor          # real embeddings [N, n_h]
    z_gen: torch.Tensor      # generated embeddings [N, n_h]
    x_dec: torch.Tensor      # decoded features [N, n_in]
    probs_all: torch.Tensor  # disc on cat([z, z_gen]) [2N], BN over 2N
    prob_gen: torch.Tensor   # disc on z_gen alone [N], BN over N
    probs_all_detached: torch.Tensor  # disc on the detached cat [2N]


class AEGIS(nn.Module):
    def __init__(self, n_in: int, n_h: int = 300, noise_dim: int = 16,
                 hid_dim: int = 64, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.noise_dim = noise_dim
        self.gcn_enc1 = GCNLayer(n_in, n_h, generator=generator)
        self.gcn_enc2 = GCNLayer(n_h, n_h, generator=generator)
        self.gcn_dec1 = GCNLayer(n_h, n_h, generator=generator)
        self.gcn_dec2 = GCNLayer(n_h, n_in, generator=generator)
        self.generator = PyGMLP(noise_dim, hid_dim, n_in, act="relu",
                                generator=generator)
        self.discriminator2 = PyGMLP(n_h, hid_dim, 1, act="sigmoid",
                                     generator=generator)

    def encode(self, adj, x: torch.Tensor) -> torch.Tensor:
        return self.gcn_enc2(adj, self.gcn_enc1(adj, x))

    def forward(self, adj, x: torch.Tensor,
                noise: torch.Tensor) -> AEGISOutput:
        """``noise``: the generator's ``[N, noise_dim]`` draw."""
        z_gen = self.encode(adj, self.generator(noise))
        z = self.encode(adj, x)
        x_dec = self.gcn_dec2(adj, self.gcn_dec1(adj, z))
        emb_all = torch.cat([z, z_gen], dim=0)
        disc = self.discriminator2
        probs_all = torch.sigmoid(disc(emb_all))[:, 0]
        prob_gen = torch.sigmoid(disc(z_gen))[:, 0]
        probs_all_det = torch.sigmoid(disc(emb_all.detach()))[:, 0]
        return AEGISOutput(z, z_gen, x_dec, probs_all, prob_gen,
                           probs_all_det)


def aegis_losses(out: AEGISOutput, x: torch.Tensor,
                 train_idx: torch.Tensor):
    """(loss_ae, loss_dis, loss_g), reference ``model_AEGIS.py:215-237``.

    ``loss_g = BCE(prob_gen, 0)`` is not detached: it drives generator,
    encoder and discriminator alike, as in the reference. ``loss_dis`` is
    the intended discriminator objective (real → 0 over the train rows,
    generated → 1 over all rows, on the detached forward), which the
    reference computes and discards (``model_AEGIS.py:222-224,240``)."""
    n = x.shape[0]
    loss_ae = attr_row_error(x, out.x_dec)[train_idx].mean()
    p_real_d = out.probs_all_detached[:n][train_idx]
    p_gen_d = out.probs_all_detached[n:]
    loss_dis = (bce_probs(p_real_d, 0.0).sum()
                + bce_probs(p_gen_d, 1.0).sum()) \
        / (p_real_d.shape[0] + p_gen_d.shape[0])
    loss_g = bce_probs(out.prob_gen, 0.0).mean()
    return loss_ae, loss_dis, loss_g


def aegis_scores(out: AEGISOutput) -> torch.Tensor:
    """The discriminator's fake-probability of the real nodes, from the
    concatenated forward (reference ``model_AEGIS.py:239``)."""
    return out.probs_all[:out.z.shape[0]]
