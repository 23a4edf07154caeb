"""Neural layers shared by the models (counterpart of
``ggad_tpu/nn/layers.py``).

  * :class:`PReLU` — one shared parameter, init 0.25.
  * :class:`DenseNoBias` — weight ``[out, in]``, Xavier-uniform init drawn
    from an explicit generator (the distribution of flax's
    ``xavier_uniform``; the values differ, since the generators differ).
    :func:`dense` is flax's ``nn.Dense`` (with bias, LeCun-normal init).
  * :class:`GCNLayer` — h' = act(Â @ (h W) + b), with the ``pre_agg``
    hoist (Â(xW) = (Âx)W); GGAD's configuration is the default (bias,
    PReLU), the baselines also take ReLU, none and no bias.
  * :class:`MLPHead` — n_h → n_h/2 → n_h/4 → 1, all bias-free.
  * :class:`GATLayer` — single-head graph attention (AnomalyDAE).
  * :class:`BilinearDiscriminator` and :func:`readout` — carried for
    parity (reference ``model.py:38-105``); no forward uses them.

Parameter names follow the flax modules', so
``interop.params_from_flax`` maps each tree without special cases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
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


def xavier_uniform(fan_out: int, fan_in: int,
                   generator: Optional[torch.Generator] = None
                   ) -> nn.Parameter:
    """A ``[fan_out, fan_in]`` parameter, Xavier-uniform."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(fan_out, fan_in, dtype=torch.float32)
    return nn.Parameter(w.uniform_(-bound, bound, generator=generator))


def dense(in_features: int, out_features: int, *,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """flax's ``nn.Dense``: a biased linear layer, LeCun-normal weight
    (truncated at two standard deviations), zero bias."""
    lin = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class DenseNoBias(nn.Module):
    """Linear layer without bias, Xavier-uniform init."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = xavier_uniform(out_features, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.t()


GCN_ACTS = ("prelu", "relu", "none")


class GCNLayer(nn.Module):
    """h' = act(Â @ (h W) + b) — reference ``model.py:26-35``. The
    aggregation dispatches on the graph's type (``ops.spmm``: COO, BCSR
    tiles or ELL tables). ``act`` is ``"prelu"`` (GGAD's), ``"relu"`` or
    ``"none"``; without ``use_bias`` the layer has no bias."""

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True, act: str = "prelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in GCN_ACTS:
            raise ValueError(f"unknown act {act!r}")
        self.act = act
        self.fc = DenseNoBias(in_features, features, generator=generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        if act == "prelu":
            self.prelu = PReLU()

    def forward(self, adj, x: torch.Tensor,
                pre_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pre_agg``: optional precomputed ``Â @ x``; the layer is then
        one dense product (same parameters, same math)."""
        if pre_agg is not None:
            out = self.fc(pre_agg)
        else:
            out = spmm(adj, self.fc(x))
        if self.bias is not None:
            out = out + self.bias
        if self.act == "prelu":
            return self.prelu(out)
        if self.act == "relu":
            return torch.relu(out)
        return out


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


class BilinearDiscriminator(nn.Module):
    """Bilinear critic f(h, c) = hᵀ W c + b with rotate-the-batch
    negatives (reference ``model.py:76-105``). The reference builds it but
    never calls it in GGAD's forward; carried for parity. ``weight`` is
    flax's ``kernel`` transposed, ``[d_c, d_h]``."""

    def __init__(self, d_h: int, d_c: int, negsamp_rounds: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.negsamp_rounds = negsamp_rounds
        self.weight = xavier_uniform(d_c, d_h, generator)
        self.bias = nn.Parameter(torch.zeros(()))

    def forward(self, c: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        hw = h @ self.weight.t()
        scores = [(hw * c).sum(dim=1) + self.bias]
        c_mi = c
        for _ in range(self.negsamp_rounds):
            # rotate: prepend the second-to-last row, drop the last
            c_mi = torch.cat([c_mi[-2:-1], c_mi[:-1]], dim=0)
            scores.append((hw * c_mi).sum(dim=1) + self.bias)
        return torch.cat(scores, dim=0)[:, None]


class GATLayer(nn.Module):
    """Single-head graph attention (GATConv semantics; the AnomalyDAE
    baseline, reference ``model_AnomalyDAE.py:123``):
    α_ij = softmax_j(LeakyReLU(a_src·Wh_j + a_dst·Wh_i)) over the edges
    j→i of ``g`` (self-loops come from the caller's graph), out_i =
    Σ α_ij Wh_j + b. Edge-parallel: logits per edge, a segment softmax at
    the destination and a weighted ``index_add``, never N×N.

    Padding edges (val == 0) join no softmax. The segment max is not
    detached, as in JAX: its gradient cancels only to rounding."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.weight = xavier_uniform(features, in_features, generator)
        self.att_src = xavier_uniform(1, features, generator)
        self.att_dst = xavier_uniform(1, features, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        n = g.n_nodes
        h = x @ self.weight.t()
        alpha_src = (h * self.att_src).sum(dim=-1)
        alpha_dst = (h * self.att_dst).sum(dim=-1)
        # edge (row → col): message from row, aggregated at col
        logits = F.leaky_relu(alpha_src[g.row] + alpha_dst[g.col],
                              self.negative_slope)
        valid = g.val != 0
        logits = torch.where(valid, logits, -torch.inf)
        seg_max = torch.full((n,), -torch.inf, dtype=h.dtype,
                             device=h.device).scatter_reduce(
            0, g.col, logits, "amax", include_self=False)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        ex = torch.where(valid, torch.exp(logits - seg_max[g.col]), 0.0)
        zeros = torch.zeros(n, dtype=h.dtype, device=h.device)
        denom = zeros.index_add(0, g.col, ex)
        att = ex / torch.clamp_min(denom[g.col], 1e-16)
        out = torch.zeros_like(h).index_add(0, g.col,
                                            h[g.row] * att[:, None])
        return out + self.bias


def readout(seq: torch.Tensor, mode: str = "avg",
            query: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Graph readout over the node axis (reference ``model.py:38-73``)."""
    if mode == "avg":
        return seq.mean(dim=-2)
    if mode == "max":
        return seq.amax(dim=-2)
    if mode == "min":
        return seq.amin(dim=-2)
    if mode == "weighted_sum":
        if query is None:
            raise ValueError("the weighted_sum readout needs a query")
        sim = torch.softmax(torch.einsum("...nd,...d->...n", seq, query),
                            dim=-1)
        return torch.einsum("...nd,...n->...d", seq, sim)
    raise ValueError(f"unknown readout {mode!r}")
