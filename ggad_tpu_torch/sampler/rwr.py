"""Random walks with restart and the degree-weighted id sampler
(counterpart of ``ggad_tpu/sampler/rwr.py``).

Reference counterparts: ``utils.py:151-172`` (``generate_rwr_subgraph``)
and ``src/utils.py:133-137`` (``pick_step``), both dead code there and in
both packages: they are carried for parity. Walks have a fixed length
with a restart draw a step, so the traces are ``[S, walk_len]``, and each
seed's subgraph is its first unique visited nodes, padded and masked (the
reference's retry loop becomes a fixed walk budget).

``jax.random`` cannot be reproduced in torch, so the uniform draws are
arguments: ``rwr_traces`` takes the step offsets' and the restarts'
(JAX's two halves of ``split(key)`` at each step), ``pick_step`` the
draw that ``jax.random.choice`` makes.
"""

from __future__ import annotations

import torch

from ggad_tpu_torch.sampler.neighbor import NeighborTable


def rwr_traces(table: NeighborTable, seeds: torch.Tensor,
               restart_prob: float, u_step: torch.Tensor,
               u_restart: torch.Tensor) -> torch.Tensor:
    """``[S, walk_len]`` node traces: uniform neighbor steps, each walker
    back at its seed when its restart draw is below ``restart_prob``.
    ``u_step`` and ``u_restart`` are ``[walk_len, S]``. A zero-degree
    walker stays where it is."""
    seeds = seeds.int()
    cur, trace = seeds, []
    for us, ur in zip(u_step, u_restart):
        start = table.indptr[cur]
        deg = table.indptr[cur + 1] - start
        offs = (us * deg.clamp(min=1).float()).int()
        nxt = table.indices[start + torch.minimum(offs, (deg - 1).clamp(
            min=0))]
        nxt = torch.where(deg > 0, nxt, cur)
        cur = torch.where(ur < restart_prob, seeds, nxt)
        trace.append(cur)
    return torch.stack(trace, dim=1)


def rwr_subgraphs(table: NeighborTable, seeds: torch.Tensor, *,
                  subgraph_size: int, u_step: torch.Tensor,
                  u_restart: torch.Tensor, restart_prob: float = 0.5
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each seed's RWR subgraph (reference ``utils.py:151-172``): (nodes
    ``[S, subgraph_size]`` int32, mask ``[S, subgraph_size]`` float32),
    the first unique nodes a restart walk from the seed visits, the seed
    in slot 0; unfilled slots repeat the seed with mask 0. The walk's
    length is the draws' (JAX defaults it to 3× the subgraph size).

    JAX fills the slots in a sequential ``lax.scan`` a seed; here the loop
    runs over the walk's steps, every seed at once."""
    seeds = seeds.int()
    trace = rwr_traces(table, seeds, restart_prob, u_step, u_restart)
    s = seeds.shape[0]
    nodes = seeds[:, None].repeat(1, subgraph_size)
    mask = torch.zeros(s, subgraph_size, device=seeds.device)
    mask[:, 0] = 1.0
    count = torch.ones(s, dtype=torch.long, device=seeds.device)
    rows = torch.arange(s, device=seeds.device)
    for v in trace.T:
        seen = ((nodes == v[:, None]) & (mask > 0)).any(1)
        take = ~seen & (count < subgraph_size)
        idx = count.clamp(max=subgraph_size - 1)
        nodes[rows, idx] = torch.where(take, v, nodes[rows, idx])
        mask[rows, idx] = torch.where(take, 1.0, mask[rows, idx])
        count = count + take.long()
    return nodes, mask


def pick_step(idx_train: torch.Tensor, y_train: torch.Tensor,
              degrees: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Degree-weighted, label-balanced draws of training ids (reference
    ``src/utils.py:133-137``): id i has weight degree_i / lf_i with
    lf_i = (Σy − |y|)·y_i + |y|, so positives are down-weighted by the
    class imbalance. One id a draw of ``u`` ([size], uniform).

    ``jax.random.choice(p=…)``'s inverse CDF: the first i with
    cdf_i ≥ cdf_last·(1 − u). The CDF is summed in float64, so the card
    and the host give the same ids at any size (an f32 prefix sum in a
    device's own order moves the bucket edges by more than a bucket at
    millions of ids); JAX's f32 sum can differ only for a draw within
    rounding of an edge."""
    y = y_train.float()
    n = y.shape[0]
    lf = (y.sum() - n) * y + n
    cdf = torch.cumsum((degrees.float() / lf).double(), 0)
    r = cdf[-1] * (1 - u.double())
    return idx_train[torch.searchsorted(cdf, r)]
