"""GAAN baseline, a generative adversarial attributed network
(counterpart of ``ggad_tpu/models/gaan.py``).

Reference (``model_gaan.py``, ``gaan.py``):
  * generator: PyG ``MLP`` noise(16)→64→n_in, fake features x_;
  * encoder (the "discriminator"): PyG ``MLP`` x→64→64, no graph
    convolution;
  * edge probabilities a_ij = σ(z_i·z_j) and a'_ij = σ(z'_i·z'_j) over the
    edges whose source is a train node (``model_gaan.py:266-270,318-322``):
    loss = ½·[BCE(a, 1) + BCE(a'.detach(), 0)];
  * generator loss: per-row feature reconstruction L2 over the train rows;
  * anomaly score: the attribute reconstruction error.

Both MLPs carry PyG's train-mode BatchNorm (:class:`PyGMLP`); the encoder's
two calls (real x, generated x_) are separate forwards with separate
batch statistics, as ``model_gaan.py:296-298``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.models.aegis import PyGMLP
from ggad_tpu_torch.ops.bce import bce_probs
from ggad_tpu_torch.ops.dense_blocks import attr_row_error


class GAANOutput(NamedTuple):
    z: torch.Tensor        # encoded real features [N, h]
    z_gen: torch.Tensor    # encoded fake features [N, h]
    x_gen: torch.Tensor    # generated features [N, n_in]


class GAAN(nn.Module):
    def __init__(self, n_in: int, noise_dim: int = 16, hid_dim: int = 64,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.noise_dim = noise_dim
        self.generator = PyGMLP(noise_dim, hid_dim, n_in, act="relu",
                                generator=generator)
        self.discriminator = PyGMLP(n_in, hid_dim, hid_dim, act="relu",
                                    generator=generator)

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> GAANOutput:
        """``noise``: the generator's ``[N, noise_dim]`` draw."""
        x_gen = self.generator(noise)
        return GAANOutput(self.discriminator(x), self.discriminator(x_gen),
                          x_gen)


def train_edge_mask(g, train_mask_nodes: torch.Tensor) -> torch.Tensor:
    """Edges whose source row is a train node (reference
    ``neighList_to_edgeList_train``) and that are not padding."""
    return train_mask_nodes[g.row] & (g.val != 0)


def gaan_losses(out: GAANOutput, g, x: torch.Tensor,
                train_node_mask: torch.Tensor, train_idx: torch.Tensor):
    """(loss_dis, loss_g); ``train_node_mask`` is ``[N]`` bool. The BCE is
    torch's own (log clamped at -100, no probability clip): under a
    saturated discriminator each edge adds 100, as in the reference."""
    w = train_edge_mask(g, train_node_mask).to(x.dtype)
    denom = torch.clamp_min(w.sum(), 1.0)

    def edge_sigmoid(z):
        return torch.sigmoid((z[g.row] * z[g.col]).sum(dim=1))

    loss_r = (w * bce_probs(edge_sigmoid(out.z), 1.0)).sum() / denom
    loss_f = (w * bce_probs(edge_sigmoid(out.z_gen.detach()), 0.0)).sum() \
        / denom
    loss_g = attr_row_error(x, out.x_gen)[train_idx].mean()
    return 0.5 * (loss_r + loss_f), loss_g


def gaan_scores(out: GAANOutput, x: torch.Tensor) -> torch.Tensor:
    """score_i = ‖x_i − x̂_i‖₂ (reference ``model_gaan.py:328-334``)."""
    return attr_row_error(x, out.x_gen)
