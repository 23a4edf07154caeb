"""GGAD (counterpart of ``ggad_tpu/models/ggad.py``): the encoder and the
eval branch that serving runs.

  * 2-layer GCN encoder (n_in → n_h → n_h, PReLU) over a sparse Â;
    gcn1 runs on the hoisted ``Â·x`` when given, gcn2's Â·(hW₂) goes
    through ``ops.spmm`` (the BCSR kernel on a tile-dense graph).
  * One-class MLP head: one logit per node (higher = more anomalous).

The module owns ``gcn1``, ``gcn2``, ``head`` and ``fc4`` so that the whole
flax parameter tree maps across (:mod:`ggad_tpu_torch.interop`). The
train branch (outlier generation through ``fc4``, ``replace_rows``, the
noise draw) comes with the training slice. The JAX eval branch draws seed
noise that never reaches the logits; the port draws none.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ggad_tpu_torch.nn.layers import DenseNoBias, GCNLayer, MLPHead


class GGADOutput(NamedTuple):
    emb: torch.Tensor       # [N, n_h] embeddings
    logits: torch.Tensor    # [N, 1] one-class logits (eval)


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

    def forward(self, adj, x: torch.Tensor, *, train: bool = False,
                ax: Optional[torch.Tensor] = None) -> GGADOutput:
        """Eval forward (``ggad.py:127-129,166-169``). ``ax``: optional
        precomputed ``Â @ x``, which hoists the first layer's
        aggregation."""
        if train:
            raise NotImplementedError(
                "GGAD's train branch comes with the training slice "
                "(ROADMAP Queue 1, item 1)")
        emb = self.encode(adj, x, ax=ax)
        return GGADOutput(emb=emb, logits=self.head(emb))
