"""Neural layers of GGAD (counterpart of ``ggad_tpu/nn/layers.py:32-107``).

  * :class:`PReLU` — one shared parameter, init 0.25.
  * :class:`DenseNoBias` — weight ``[out, in]``, Xavier-uniform init drawn
    from an explicit generator (the distribution of flax's
    ``xavier_uniform``; the values differ, since the generators differ).
  * :class:`GCNLayer` — h' = PReLU(Â @ (h W) + b), with the ``pre_agg``
    hoist (Â(xW) = (Âx)W); GGAD's only configuration (the baselines'
    ReLU / no-bias variants come with the baseline zoo).
  * :class:`MLPHead` — n_h → n_h/2 → n_h/4 → 1, all bias-free.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ggad_tpu_torch.ops.spmm import spmm


class PReLU(nn.Module):
    """Single-shared-parameter PReLU, init 0.25."""

    def __init__(self, init_alpha: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(init_alpha,
                                               dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class DenseNoBias(nn.Module):
    """Linear layer without bias, Xavier-uniform init."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(out_features, in_features, dtype=torch.float32)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.t()


class GCNLayer(nn.Module):
    """h' = PReLU(Â @ (h W) + b) — reference ``model.py:26-35``. The
    aggregation dispatches on the graph's type (``ops.spmm``: COO, BCSR
    tiles or ELL tables)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = DenseNoBias(in_features, features, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.prelu = PReLU()

    def forward(self, adj, x: torch.Tensor,
                pre_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pre_agg``: optional precomputed ``Â @ x``; the layer is then
        one dense product (same parameters, same math)."""
        if pre_agg is not None:
            out = self.fc(pre_agg)
        else:
            out = spmm(adj, self.fc(x))
        return self.prelu(out + self.bias)


class MLPHead(nn.Module):
    """fc1→ReLU→fc2→ReLU→fc3 one-class scoring head
    (reference ``model.py:115-117``)."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 out: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = [in_features, *hidden, out]
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            self.add_module(f"fc{i + 1}", DenseNoBias(
                sizes[i], sizes[i + 1], generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n_layers):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.n_layers}")(x)
