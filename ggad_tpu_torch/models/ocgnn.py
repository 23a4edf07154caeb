"""OCGNN baseline, a one-class GNN (counterpart of
``ggad_tpu/models/ocgnn.py``).

Reference (``ocgnn.py:80-113``, ``model_ocgnn.py:109-131``): a 2-layer GCN
encoder and the hypersphere loss on the labeled normals' embeddings

    dist_i = ‖emb_i − c‖²,   score_i = dist_i − r²,
    loss   = r² + (1/β)·mean(relu(score))        β = 0.5

The reference re-creates r = 0 and c = 0 on every call, so its warmup
never takes effect; that is the default here. ``use_warmup=True`` runs the
intended warmup: for ``warmup`` steps, c and r are set from the step's
embeddings (r the linear (1−β) quantile of the distances, as
``jnp.quantile``) after the loss has read the old ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.nn.layers import GCNLayer


class OCGNNEncoder(nn.Module):
    def __init__(self, n_in: int, n_h: int = 300, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gcn1 = GCNLayer(n_in, n_h, generator=generator)
        self.gcn2 = GCNLayer(n_h, n_h, generator=generator)

    def forward(self, adj, x: torch.Tensor) -> torch.Tensor:
        return self.gcn2(adj, self.gcn1(adj, x))


class OCGNNState(NamedTuple):
    center: torch.Tensor   # [n_h]
    radius: torch.Tensor   # scalar
    warmup_left: int


def init_ocgnn_state(n_h: int, warmup: int = 2,
                     device=None) -> OCGNNState:
    return OCGNNState(center=torch.zeros(n_h, device=device),
                      radius=torch.zeros((), device=device),
                      warmup_left=warmup)


def ocgnn_loss(emb_train: torch.Tensor, state: OCGNNState,
               beta: float = 0.5, eps: float = 1e-3,
               use_warmup: bool = False):
    """Returns (loss, scores, new_state)."""
    dist = torch.square(emb_train - state.center).sum(dim=1)
    score = dist - torch.square(state.radius)
    loss = torch.square(state.radius) + (1.0 / beta) * torch.relu(
        score).mean()
    if not use_warmup or state.warmup_left <= 0:
        return loss, score, state
    with torch.no_grad():
        r = torch.quantile(torch.sqrt(dist), 1.0 - beta)
        c = emb_train.mean(dim=0)
        small = c.abs() < eps
        c = torch.where(small & (c < 0), -eps, c)
        c = torch.where(small & (c > 0), eps, c)
    return loss, score, OCGNNState(c, r, state.warmup_left - 1)


def ocgnn_scores(emb: torch.Tensor, state: OCGNNState) -> torch.Tensor:
    return torch.square(emb - state.center).sum(dim=1) - torch.square(
        state.radius)
