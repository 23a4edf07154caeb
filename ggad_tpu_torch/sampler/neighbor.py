"""Fixed-fanout neighbor sampling on the device (counterpart of
``ggad_tpu/sampler/neighbor.py:29-89``).

The CSR adjacency lives on the device as two int32 tensors. For each query
node K uniform draws pick offsets into its CSR row and the neighbor ids
are gathered: static ``[B, K]`` shapes, no host round trip. Sampling is
with replacement; a zero-degree row returns the node itself with mask 0.

``jax.random`` cannot be reproduced in torch, so the uniform draws are
arguments: the trainer draws them from its own generator, a test passes
JAX's. The offset arithmetic is JAX's (f32 ``floor(u · max(deg, 1))``
clamped to ``deg − 1``), so the same draws give the same ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.graph import Graph


@dataclasses.dataclass(frozen=True)
class NeighborTable:
    """Device-resident CSR adjacency for sampling (no edge values)."""

    indptr: torch.Tensor   # [N+1] int32
    indices: torch.Tensor  # [E_pad] int32, row-sorted neighbor ids
    n_nodes: int

    @classmethod
    def from_graph(cls, g: Graph) -> "NeighborTable":
        return cls(indptr=g.indptr.int(), indices=g.col.int(),
                   n_nodes=g.n_nodes)

    @classmethod
    def from_scipy(cls, mat, *, device: DeviceLike = None
                   ) -> "NeighborTable":
        device = resolve_device(device)
        csr = mat.tocsr()
        indices = csr.indices
        if indices.shape[0] == 0:   # empty graph: keep gathers in range
            indices = np.zeros(1, np.int32)
        return cls(
            indptr=torch.from_numpy(
                np.asarray(csr.indptr, np.int32)).to(device),
            indices=torch.from_numpy(
                np.asarray(indices, np.int32)).to(device),
            n_nodes=mat.shape[0])

    def degrees_of(self, nodes: torch.Tensor) -> torch.Tensor:
        return self.indptr[nodes + 1] - self.indptr[nodes]


def sample_neighbors(table: NeighborTable, nodes: torch.Tensor, fanout: int,
                     u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` neighbors of each node in ``nodes`` ([B] int32)
    from the uniform draws ``u`` ([B, fanout] f32 in [0, 1)).

    Returns (neigh [B, K] int32, mask [B, K] float32). Zero-degree nodes
    get themselves with mask 0.
    """
    start = table.indptr[nodes]                              # [B]
    deg = table.indptr[nodes + 1] - start                    # [B]
    offs = torch.floor(u * deg.clamp(min=1)[:, None].float()).int()
    offs = torch.minimum(offs, (deg - 1).clamp(min=0)[:, None])
    neigh = table.indices[start[:, None] + offs]
    has = (deg > 0)[:, None]
    neigh = torch.where(has, neigh, nodes[:, None])
    mask = has.float().expand(-1, fanout)
    return neigh, mask


def sample_two_hop(table: NeighborTable, nodes: torch.Tensor, k1: int,
                   k2: int, u1: torch.Tensor, u2: torch.Tensor):
    """Two-hop fixed-fanout sampling: ``u1`` [B, K1] draws the first hop,
    ``u2`` [B·K1, K2] the second (JAX's two halves of ``split(rng)``).

    Returns (n1 [B,K1], m1 [B,K1], n2 [B,K1,K2], m2 [B,K1,K2]).
    """
    n1, m1 = sample_neighbors(table, nodes, k1, u1)
    n2, m2 = sample_neighbors(table, n1.reshape(-1), k2, u2)
    b = nodes.shape[0]
    return n1, m1, n2.reshape(b, k1, k2), m2.reshape(b, k1, k2)
