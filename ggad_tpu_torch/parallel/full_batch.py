"""Full-batch GGAD over a mesh on the all-gather layout, the counterpart of
the GSPMD path (``ggad_tpu/parallel/full_batch.py``).

Torch has no auto-partitioner, so the layout is explicit:
  * the normalized and raw graphs are row-owner edge blocks
    (``spmm_shard.partition_edges``: shard d holds the edges of its R rows);
  * node-indexed arrays (features, embeddings) are ``[n, R, ...]`` blocks
    of the node shards the mesh owns;
  * the parameters are replicated and enter per-shard compute through
    ``pvary``; with 2-D tensor parallelism over a ``('nodes', 'model')``
    mesh, :func:`shard_params_2d` shards each weight's output dim over
    ``'model'`` (JAX's rule) and its products are column-parallel, their
    outputs all-gathered on ``'model'`` before the next layer.

Each aggregation all-gathers the node-sharded operand and sums each
shard's edges into its rows (``spmm_shard.spmm_sharded``), which is what
XLA's partitioner does for JAX's gather and ``segment_sum``. JAX shards
the COO in contiguous edge chunks; the port shards it by row owner: the
same values. The step is the JAX trainer's (``full_batch.py:221-241``):
the hoisted Â·x, the seed rows' generator aggregation as partials and a
``psum``, the margin's affinity at the labeled columns only
(``halo_trainer.sharded_ggad_losses``, shared with the halo path). JAX
forces its XLA op path here (``full_batch.py:164-168``), so the port runs
the edge-parallel gathers and launches neither K1 nor K2.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ggad_tpu_torch.device import DeviceLike
from ggad_tpu_torch.graph import from_scipy
from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.models.ggad import GGAD
from ggad_tpu_torch.ops.normalize import normalize_adj_reference
from ggad_tpu_torch.parallel.halo_trainer import (
    Params,
    ShardOps,
    sharded_ggad_losses,
    sharded_ggad_scores,
)
from ggad_tpu_torch.parallel.mesh import Mesh2D, make_mesh
from ggad_tpu_torch.parallel.spmm_shard import (
    EdgePartition,
    HaloAffinitySubset,
    HaloSeedRows,
    NodeIndex,
    build_halo_affinity_subset,
    build_halo_seed_rows,
    node_index,
    pad_nodes,
    partition_edges,
    place_halo_affinity_subset,
    place_halo_seed_rows,
    place_nodes,
    place_partition,
    spmm_sharded,
)
from ggad_tpu_torch.train.losses import GGADLosses

NOISE_MEAN, NOISE_STD = 0.02, 0.01       # full_batch.py:84, 171


def _axis(mesh, axis: str):
    """The 1-D communicator over ``axis`` (a 1-D mesh is its own)."""
    return mesh.axis(axis) if isinstance(mesh, Mesh2D) else mesh


def shard_graph(g, mesh, axis: str = "nodes") -> EdgePartition:
    """``g``'s edges (a ``graph.Graph``) in row-owner blocks over ``axis``,
    the owned ones placed on the mesh's device."""
    comm = _axis(mesh, axis)
    return place_partition(partition_edges(g, comm.n_shards), comm)


def shard_node_array(x, mesh, axis: str = "nodes") -> torch.Tensor:
    """A ``[N, ...]`` node array padded to whole shards of
    ``ceil(N / D)`` rows (``partition_edges``'s) and the owned blocks
    ``[n, R, ...]`` placed on the mesh's device."""
    comm = _axis(mesh, axis)
    x = torch.as_tensor(x)
    rows = -(-x.shape[0] // comm.n_shards)
    pad = x.new_zeros((rows * comm.n_shards - x.shape[0],)
                      + tuple(x.shape[1:]))
    blocks = torch.cat([x, pad]).view((comm.n_shards, rows)
                                      + tuple(x.shape[1:]))
    return place_nodes(blocks, comm)


def replicate(x, mesh):
    """A tensor, or a mapping of them, on the mesh's device."""
    if isinstance(x, Mapping):
        return {k: replicate(v, mesh) for k, v in x.items()}
    return torch.as_tensor(x).to(mesh.device)


def tp_sharded(name: str, t: torch.Tensor, m: int) -> bool:
    """JAX's placement rule (``full_batch.py:58-81``) on the flax leaf of
    ``name``: its last axis shards over ``'model'`` when ``m`` divides it
    and it is at least ``m``; scalars replicate. The flax leaf's last axis
    is a weight's output dim, the port's dim 0 of ``[out, in]``
    (``interop`` swaps the last two), and a bias's only dim."""
    if t.ndim == 0:
        return False
    out = t.shape[-2] if name.endswith("weight") and t.ndim >= 2 \
        else t.shape[-1]
    return out % m == 0 and out >= m


def shard_params_2d(params: Params, mesh: Mesh2D,
                    axis: str = "model") -> dict:
    """Tensor-parallel placement: every leaf :func:`tp_sharded` picks is
    split along its output dim into ``m`` blocks and keeps the owned ones,
    ``[B, out/m, ...]``; the rest (the PReLU slopes, a head's width-1
    output) is whole. All on the mesh's device."""
    comm = mesh.axis(axis)
    m = comm.n_shards
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v).to(comm.device)
        if tp_sharded(k, v, m):
            v = v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
            v = v[comm.shards]
        out[k] = v
    return out


@dataclasses.dataclass
class GSPMDSetup:
    """What a GSPMD step reads, placed on the node shards a mesh owns:
    the partition of the normalized graph, the hoisted Â·x, the seed and
    labeled-normal indices, the seed rows and the margin's subset (on the
    raw graph's partition). ``route`` is ``"coo"``: no tile or table."""

    part: EdgePartition
    ax: torch.Tensor
    seed_idx: NodeIndex
    normal_idx: NodeIndex
    seed_rows: HaloSeedRows
    aff_sub: HaloAffinitySubset
    route: str = "coo"

    def ops(self, mesh, sharded: frozenset = frozenset()) -> ShardOps:
        """The forward's operations: the all-gather aggregation over the
        node shards and, on a :class:`Mesh2D`, the ``'model'`` axis for
        the ``sharded`` parameters."""
        nodes = _axis(mesh, "nodes")
        model = mesh.axis("model") if isinstance(mesh, Mesh2D) else None
        return ShardOps(nodes, lambda h: spmm_sharded(self.part, h, nodes),
                        model, frozenset(sharded))

    def losses(self, params: Params, noise: torch.Tensor, mesh, *,
               sharded: frozenset = frozenset(),
               confidence_margin: float = 0.7,
               pos_weight: float = 1.0) -> GGADLosses:
        return sharded_ggad_losses(
            params, self.ops(mesh, sharded), self.part, self.ax,
            self.seed_idx, self.normal_idx, noise, self.seed_rows,
            self.aff_sub, confidence_margin=confidence_margin,
            pos_weight=pos_weight)

    def scores(self, params: Params, mesh,
               sharded: frozenset = frozenset()) -> torch.Tensor:
        """One logit per node, the replicated ``[D·R]`` (no gradient)."""
        with torch.no_grad():
            return sharded_ggad_scores(params, self.ops(mesh, sharded),
                                       self.ax)


def prepare_gspmd(dataset, mesh) -> GSPMDSetup:
    """Partition the normalized and raw graphs by row owner over the
    mesh's node shards, build the seed rows and the labeled-column subset
    (edge-parallel, as JAX's XLA path), and compute Â·x once."""
    comm = _axis(mesh, "nodes")
    D = comm.n_shards
    adj, raw_adj = normalize_adj_reference(from_scipy(dataset.adj,
                                                      device="cpu"))
    part = partition_edges(adj, D)
    labeled = np.concatenate([
        np.asarray(dataset.normal_label_idx, np.int64),
        np.asarray(dataset.abnormal_label_idx, np.int64)])
    seed_rows = place_halo_seed_rows(
        build_halo_seed_rows(part, dataset.abnormal_label_idx), comm)
    aff_sub = place_halo_affinity_subset(build_halo_affinity_subset(
        partition_edges(raw_adj, D), labeled), comm)
    x = place_nodes(pad_nodes(torch.as_tensor(
        np.asarray(dataset.features, np.float32)), part), comm)
    part = place_partition(part, comm)
    with torch.no_grad():
        ax = spmm_sharded(part, x, comm)
    R = part.rows_per_shard
    return GSPMDSetup(
        part=part, ax=ax,
        seed_idx=node_index(dataset.abnormal_label_idx, R, comm),
        normal_idx=node_index(dataset.normal_label_idx, R, comm),
        seed_rows=seed_rows, aff_sub=aff_sub)


def make_sharded_train_step(setup: GSPMDSetup,
                            optimizer: torch.optim.Optimizer, mesh, *,
                            sharded: frozenset = frozenset(),
                            confidence_margin: float = 0.7,
                            pos_weight: float = 1.0) -> Callable:
    """``step(params, noise)``: one optimizer step of the GSPMD forward at
    the trainable ``params`` (the optimizer's), noise ``[S, n_h]``;
    returns the losses, detached (``full_batch.py:125-151``)."""

    def step(params: Params, noise: torch.Tensor) -> GGADLosses:
        optimizer.zero_grad(set_to_none=True)
        losses = setup.losses(params, noise, mesh, sharded=sharded,
                              confidence_margin=confidence_margin,
                              pos_weight=pos_weight)
        losses.total.backward()
        optimizer.step()
        return GGADLosses(*(t.detach() for t in losses))

    return step


def _run_steps(mesh, dataset, params: dict, sharded: frozenset, *,
               n_h: int, lr: float, seed: int, n_steps: int,
               noises: Optional[list]) -> float:
    setup = prepare_gspmd(dataset, mesh)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    step = make_sharded_train_step(
        setup, torch.optim.Adam(leaves.values(), lr=lr), mesh,
        sharded=sharded)
    gen = torch.Generator().manual_seed(seed)
    n_seed = len(dataset.abnormal_label_idx)
    losses = None
    for i in range(n_steps):
        if noises is None:
            noise = (torch.randn(n_seed, n_h, generator=gen) * NOISE_STD
                     + NOISE_MEAN)
        elif isinstance(noises[i], torch.Tensor):
            noise = noises[i].float()
        else:
            noise = torch.from_numpy(np.array(noises[i], np.float32))
        losses = step(leaves, noise.to(mesh.device))
    return float(losses.total)


def _initial(dataset, n_h: int, seed: int, initial_params: Optional[Any],
             device) -> dict:
    if initial_params is not None:
        return as_state_dict(initial_params, device)
    model = GGAD(dataset.feat_dim, n_h,
                 generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().to(device) for k, v in model.state_dict().items()}


def sharded_train_step(mesh, dataset, *, n_h: int = 64, lr: float = 1e-3,
                       seed: int = 0, n_steps: int = 1,
                       initial_params: Optional[Any] = None,
                       noises: Optional[list] = None,
                       device: DeviceLike = None) -> float:
    """Build and run ``n_steps`` GSPMD GGAD steps (Adam ``lr``, noise mean
    0.02 and scale 0.01) over ``mesh``'s node shards (a 1-D communicator,
    or a shard count for a local one on ``device``, the card by default)
    and return the last loss (``full_batch.py:154-191``). The initial
    weights (a flax tree or a ``state_dict``) and the noise of each step
    are the caller's when given, else seeded with ``seed``."""
    if isinstance(mesh, int):
        mesh = make_mesh(mesh, device=device)
    params = _initial(dataset, n_h, seed, initial_params, mesh.device)
    return _run_steps(mesh, dataset, params, frozenset(), n_h=n_h, lr=lr,
                      seed=seed, n_steps=n_steps, noises=noises)


def sharded_train_step_2d(mesh: Mesh2D, dataset, *, n_h: int = 64,
                          lr: float = 1e-3, seed: int = 0,
                          n_steps: int = 1,
                          initial_params: Optional[Any] = None,
                          noises: Optional[list] = None) -> float:
    """:func:`sharded_train_step` on a 2-D ``('nodes', 'model')`` mesh:
    node arrays and edges shard over ``'nodes'``, the weights' output dims
    over ``'model'`` (:func:`shard_params_2d`), each such product
    column-parallel and all-gathered on ``'model'`` after
    (``full_batch.py:84-122``). Returns the last loss."""
    params = _initial(dataset, n_h, seed, initial_params, mesh.device)
    m = mesh.axis("model").n_shards
    sharded = frozenset(k for k, v in params.items() if tp_sharded(k, v, m))
    return _run_steps(mesh, dataset, shard_params_2d(params, mesh), sharded,
                      n_h=n_h, lr=lr, seed=seed, n_steps=n_steps,
                      noises=noises)
