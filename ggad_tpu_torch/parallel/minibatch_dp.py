"""Data-parallel minibatch GGAD over a mesh (counterpart of
``ggad_tpu/parallel/minibatch_dp.py``).

The batch ``[B]`` splits into D contiguous slices of B/D, one a shard, as
JAX's ``P(axis)`` sharding does. Each shard samples, aggregates, encodes
and scores its slice against the replicated feature and neighbor tables
(a :class:`~ggad_tpu_torch.parallel.mesh.LocalMesh` holds them once; a
rank of a ``DistMesh`` holds its own copy), with the single-device draws
sliced on the same axis: ``u1 [B, K1]`` by rows, ``u2 [B·K1, K2]`` by the
matching ``B/D·K1`` rows. So D shards see exactly the single-device draws.

The losses of ``models.sage.minibatch_ggad_losses`` are means over global
slot groups: the BCE over all B rows, the mean affinity of the normal
slots and of the anomaly slots (the last ``n_anom``), and the ego term
over the anomaly slots. A shard may hold one group only (at B 200 and D 4
the last shard holds anomaly slots alone), so each shard forms its masked
sums by global slot position, one ``psum`` adds them, and the means divide
by the global counts; the margin's hinge is taken after the ``psum``. The
generator runs row by row, so it shards as it is. The parameters enter the
per-shard compute through ``mesh.pvary``: each one's gradient is the
single-device gradient on every shard (``parallel.mesh``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from ggad_tpu_torch.device import DeviceLike
from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.models.sage import (
    MiniBatchGGAD,
    MiniBatchGGADLosses,
    l2_normalize,
)
from ggad_tpu_torch.parallel.mesh import make_mesh
from ggad_tpu_torch.sampler.neighbor import NeighborTable
from ggad_tpu_torch.train.losses import bce_with_logits


def batch_slices(mesh, x: torch.Tensor) -> torch.Tensor:
    """The owned shards' contiguous slices of a tensor whose dim 0 is the
    batch axis (or rows in batch order): ``[B·k, ...]`` →
    ``[n, B/D·k, ...]``."""
    return x.reshape((mesh.n_shards, -1) + tuple(x.shape[1:]))[mesh.shards]


def check_divides(mesh, batch: int, eval_batch: int) -> None:
    """JAX's check and message (``ggad_tpu/train/minibatch.py:107-111``):
    the training batch and the scoring chunk must split evenly over the
    mesh."""
    if batch % mesh.n_shards or eval_batch % mesh.n_shards:
        raise ValueError(
            f"batch sizes ({batch}, eval {eval_batch}) must divide the "
            f"mesh size {mesh.n_shards}")


def dp_minibatch_losses(model: MiniBatchGGAD, feats: torch.Tensor,
                        table: NeighborTable, batch: torch.Tensor,
                        u1: torch.Tensor, u2: torch.Tensor, n_anom: int,
                        mesh, *, confidence_margin: float = 1.0,
                        w_rec: float = 0.1) -> MiniBatchGGADLosses:
    """``minibatch_ggad_losses`` of the batch ``[B]`` (the last ``n_anom``
    the anomaly slots) with the single-device draws ``u1 [B, K1]`` and
    ``u2 [B·K1, K2]``, computed over the mesh's shards: the replicated
    losses, with autograd recording."""
    size = batch.shape[0]
    if size % mesh.n_shards:
        raise ValueError(f"a batch of {size} does not split over "
                         f"{mesh.n_shards} shards")
    ids = batch_slices(mesh, batch)                              # [n, b]
    n, b = ids.shape
    anom = batch_slices(mesh, torch.arange(size, device=ids.device)
                        ) >= size - n_anom
    params = {k: mesh.pvary(v) for k, v in model.named_parameters()}
    out = torch.func.functional_call(
        model, params, (feats, table, ids.reshape(-1), 0, True),
        {"u1": batch_slices(mesh, u1).reshape(n * b, -1),
         "u2": batch_slices(mesh, u2).reshape(n * b * model.fanout1, -1),
         "anom": anom.reshape(-1)})
    is_anom = anom.reshape(-1)
    a = is_anom.float()
    bce = bce_with_logits(out.scores, a)
    aff = (l2_normalize(out.combined_all)
           * l2_normalize(out.context)).sum(-1)
    sq = (out.anomaly_feat - out.anomaly_feat_new).square().sum(-1)
    # no sqrt at the normal slots, whose rows may be 0 (an infinite slope)
    ego = torch.where(is_anom, sq, torch.ones_like(sq)).sqrt() * a
    parts = torch.stack([bce, aff * (1 - a), aff * a, ego], -1)
    sums = mesh.psum(parts.view(n, b, 4).sum(1))
    loss_cls = sums[0] / size
    aff_norm = sums[1] / (size - n_anom)
    aff_anom = sums[2] / n_anom
    loss_rec = sums[3] / n_anom
    loss_constraint = torch.clamp(
        confidence_margin - (aff_norm - aff_anom), min=0.0)
    total = loss_cls + loss_constraint + w_rec * loss_rec
    return MiniBatchGGADLosses(total, loss_cls, loss_constraint, loss_rec)


def make_dp_minibatch_step(model: MiniBatchGGAD,
                           optimizer: torch.optim.Optimizer, mesh,
                           n_anom: int) -> Callable:
    """``step(feats, table, batch, u1, u2)``: one data-parallel optimizer
    step (``minibatch_dp.py:25-53``); returns the losses, detached.
    ``batch`` ``[B]`` must split evenly over the mesh; keep ``n_anom``
    anomaly slots at its end."""

    def step(feats, table, batch, u1, u2) -> MiniBatchGGADLosses:
        optimizer.zero_grad(set_to_none=True)
        losses = dp_minibatch_losses(model, feats, table, batch, u1, u2,
                                     n_anom, mesh)
        losses.total.backward()
        optimizer.step()
        return MiniBatchGGADLosses(*(t.detach() for t in losses))

    return step


def run_dp_minibatch_demo(mesh, adj, features, batch_ids, *,
                          n_anom: int = 8, emb_dim: int = 16, seed: int = 0,
                          initial_params: Optional[Any] = None,
                          u1=None, u2=None,
                          device: DeviceLike = None) -> float:
    """Build and run one data-parallel step of a ``MiniBatchGGAD`` (fanouts
    4 and 3, Adam 1e-3) on ``mesh`` (a communicator, or a shard count for a
    local one on ``device``, the card by default) and return the loss
    (``minibatch_dp.py:56-76``). ``initial_params`` (a flax tree or a
    ``state_dict``) and the draws ``u1 [B, 4]``, ``u2 [B·4, 3]`` are the
    caller's when given; otherwise the weights and draws are seeded with
    ``seed``."""
    if isinstance(mesh, int):
        mesh = make_mesh(mesh, device=device)
    dev = mesh.device
    features = np.asarray(features, np.float32)
    gen = torch.Generator().manual_seed(seed)
    model = MiniBatchGGAD(features.shape[1], emb_dim, 4, 3, generator=gen)
    if initial_params is not None:
        model.load_state_dict(as_state_dict(initial_params, "cpu"))
    model = model.to(dev)
    size = len(batch_ids)
    if u1 is None:
        u1 = torch.rand(size, 4, generator=gen)
    if u2 is None:
        u2 = torch.rand(size * 4, 3, generator=gen)
    step = make_dp_minibatch_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh, n_anom)
    losses = step(torch.from_numpy(features).to(dev),
                  NeighborTable.from_scipy(adj, device=dev),
                  torch.as_tensor(np.asarray(batch_ids),
                                  dtype=torch.int32).to(dev),
                  torch.tensor(np.asarray(u1), dtype=torch.float32).to(dev),
                  torch.tensor(np.asarray(u2), dtype=torch.float32).to(dev))
    return float(losses.total)
