"""Full-batch GGAD over D shards on the boundary-halo exchange
(counterpart of ``ggad_tpu/parallel/halo_trainer.py``).

The graph is row/edge-partitioned (``spmm_shard.EdgePartition`` and
``HaloPlan``); gcn2's SpMM moves only boundary rows, the generator's seed
aggregation and the margin's affinity at the labeled nodes each become
per-shard partials and small ``psum``s. The parameters are replicated and
are exactly the single-device model's (``models.ggad.GGAD``'s
``state_dict``, so ``interop`` carries JAX's weights unchanged); the
functions below read them by name. Every replicated parameter enters the
per-shard compute through ``mesh.pvary``, which makes its gradient the
single-device one on every rank (``parallel.mesh``). The forward and
losses (:func:`sharded_ggad_losses`) are shared with the GSPMD path
(``parallel.full_batch``), which passes its own aggregation and, for 2-D
tensor parallelism, its ``'model'`` axis (:class:`ShardOps`).

The sparse route follows the single-device trainer's rule
(``train.full_batch.spmm_route`` on the whole graph): BCSR gives each
shard K1 on its local and remote rect tile pairs (2 launches a shard
forward, 2 backward) and the margin subset K2 on its rect tiles (1 launch
a shard, its backward 2 K1), in f32 and in bf16; ELL gives the flat
per-shard tables and an edge-parallel subset; ``"coo"`` the edge-parallel
halo. JAX's budget check on the per-shard tiles still sends an oversized
tile store to ELL. (JAX keys its BCSR halo to ``spmm_impl="pallas"``,
``full_batch.py:273-280``; its ``"auto"`` takes it only on a TPU.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ggad_tpu_torch.graph import from_scipy
from ggad_tpu_torch.ops.normalize import normalize_adj_reference
from ggad_tpu_torch.parallel.spmm_shard import (
    EdgePartition,
    HaloAffinitySubset,
    HaloBCSR,
    HaloELL,
    HaloPlan,
    HaloSeedRows,
    NodeIndex,
    affinity_halo_subset,
    build_halo_affinity_subset,
    build_halo_bcsr,
    build_halo_ell,
    build_halo_plan,
    build_halo_seed_rows,
    gather_rows,
    node_index,
    pad_nodes,
    partition_edges,
    place_halo_affinity_subset,
    place_halo_bcsr,
    place_halo_ell,
    place_halo_plan,
    place_halo_seed_rows,
    place_nodes,
    place_partition,
    set_rows,
    spmm_halo,
    spmm_halo_bcsr,
    spmm_halo_ell,
    spmm_halo_seed_rows,
)
from ggad_tpu_torch.train.losses import GGADLosses, bce_with_logits

Params = Mapping[str, torch.Tensor]

# JAX's per-shard tile budget (halo_trainer.py:302, 333-339): past it the
# halo takes the ELL route
BCSR_BUDGET_BYTES = 8 << 30


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _halo_mm(part, plan, mesh, tiles, ells):
    if tiles is not None:
        return lambda h: spmm_halo_bcsr(part, plan, tiles, h, mesh)
    if ells is not None:
        return lambda h: spmm_halo_ell(part, plan, ells, h, mesh)
    return lambda h: spmm_halo(part, plan, h, mesh)


@dataclasses.dataclass(frozen=True)
class ShardOps:
    """How a sharded GGAD forward runs: ``nodes`` is the 1-D communicator
    over the node shards and ``mm`` the aggregation Â·h of a node-sharded
    ``h [n, R, d]`` (the halo exchange, or the all-gather of the GSPMD
    path). With 2-D tensor parallelism, ``model`` is the communicator over
    the ``'model'`` axis and ``sharded`` the parameters whose output dim
    it shards (``parallel.full_batch.shard_params_2d``): their products
    are column-parallel and all-gathered on ``'model'`` after."""

    nodes: object
    mm: Callable
    model: object = None
    sharded: frozenset = frozenset()

    def lin(self, p: Params, name: str, h: torch.Tensor,
            node_varying: bool = True) -> torch.Tensor:
        """``h @ W.t()`` for the weight ``name``. ``node_varying``: ``h``
        is node-sharded, so a replicated ``W`` enters per-shard compute
        (``pvary`` over the node shards)."""
        w = p[name]
        if node_varying:
            w = self.nodes.pvary(w)
        if name not in self.sharded:
            return h @ w.t()
        y = torch.einsum("...i,boi->b...o", self.model.pvary(h), w)
        return self.model.all_gather(y, dim=-1)

    def vec(self, p: Params, name: str) -> torch.Tensor:
        """A bias or PReLU slope, whole, for node-sharded compute."""
        v = p[name]
        if name in self.sharded:
            v = self.model.all_gather(v)
        return self.nodes.pvary(v)


def _encode(p: Params, ops: ShardOps, ax) -> torch.Tensor:
    """The two GCN layers on sharded rows, gcn1 on the hoisted Â·x."""
    def gcn(name, h, aggregate):
        z = aggregate(ops.lin(p, f"{name}.fc.weight", h))
        return _prelu(z + ops.vec(p, f"{name}.bias"),
                      ops.vec(p, f"{name}.prelu.alpha"))

    return gcn("gcn2", gcn("gcn1", ax, lambda h: h), ops.mm)


def _head(p: Params, ops: ShardOps, h: torch.Tensor,
          node_varying: bool) -> torch.Tensor:
    h = torch.relu(ops.lin(p, "head.fc1.weight", h, node_varying))
    h = torch.relu(ops.lin(p, "head.fc2.weight", h, node_varying))
    return ops.lin(p, "head.fc3.weight", h, node_varying)


def sharded_ggad_losses(
    params: Params,
    ops: ShardOps,
    part: EdgePartition,
    ax: torch.Tensor,
    seed_idx: NodeIndex,
    normal_idx: NodeIndex,
    noise: torch.Tensor,
    seed_rows: HaloSeedRows,
    aff_sub: HaloAffinitySubset,
    *,
    confidence_margin: float = 0.7,
    pos_weight: float = 1.0,
) -> GGADLosses:
    """GGAD's train-branch forward and three-term loss over the node
    shards of ``ops`` (``models.ggad`` and ``train.losses`` term for
    term), for the halo and the GSPMD paths: ``ax`` is the sharded Â·x,
    ``noise`` the ``[S, n_h]`` perturbation; ``seed_rows`` turns the
    generator's aggregation into partials and a ``psum``; ``aff_sub``
    reads the margin's affinity at the labeled columns only."""
    p, mesh = params, ops.nodes
    emb = _encode(p, ops, ax)
    emb_abnormal = gather_rows(mesh, emb, seed_idx) + noise

    # generated outliers from neighbourhood aggregates (model.py:151-156)
    agg = spmm_halo_seed_rows(seed_rows, emb, mesh)
    emb_con = torch.relu(ops.lin(p, "fc4.weight", agg, node_varying=False))
    emb_combine = torch.cat([gather_rows(mesh, emb, normal_idx), emb_con])
    logits = _head(p, ops, emb_combine, node_varying=False)
    emb = set_rows(mesh, emb, seed_idx, emb_con)

    n_normal, n_seed = normal_idx.idx.shape[0], seed_idx.idx.shape[0]
    dev = logits.device
    labels = torch.cat([torch.zeros(n_normal, 1, device=dev),
                        torch.ones(n_seed, 1, device=dev)])
    loss_bce = bce_with_logits(logits, labels, pos_weight).mean()

    # built over [normal ‖ seed], the single-device subset's order, on
    # raw_adj's partition, whose rows_per_shard is ``part``'s
    aff = affinity_halo_subset(part, aff_sub, emb, mesh)
    aff_normal = aff[:n_normal].mean()
    aff_outlier = aff[n_normal:].mean()
    loss_margin = torch.clamp(
        confidence_margin - (aff_normal - aff_outlier), min=0.0)

    # reduced over the seed axis, as the reference does (losses.py:92-101)
    diff = (emb_con - emb_abnormal).square()
    loss_rec = diff.sum(0).sqrt().mean()

    total = loss_margin + loss_bce + loss_rec
    return GGADLosses(total, loss_bce, loss_margin, loss_rec, aff_normal,
                      aff_outlier)


def sharded_ggad_scores(params: Params, ops: ShardOps,
                        ax: torch.Tensor) -> torch.Tensor:
    """The eval branch: one one-class logit per node, the replicated
    ``[D·R]``."""
    emb = _encode(params, ops, ax)
    return ops.nodes.all_gather(_head(params, ops, emb, True)[..., 0])


def halo_ggad_forward_and_losses(
    params: Params,
    part: EdgePartition,
    plan: HaloPlan,
    ax: torch.Tensor,
    seed_idx: NodeIndex,
    normal_idx: NodeIndex,
    noise: torch.Tensor,
    seed_rows: HaloSeedRows,
    aff_sub: HaloAffinitySubset,
    mesh,
    *,
    tiles: Optional[HaloBCSR] = None,
    ells: Optional[HaloELL] = None,
    confidence_margin: float = 0.7,
    pos_weight: float = 1.0,
) -> GGADLosses:
    """:func:`sharded_ggad_losses` on the halo exchange
    (``halo_trainer.py:63-173``, its production path): ``tiles`` or
    ``ells`` pick gcn2's per-shard product (neither: the edge-parallel
    halo). (JAX's function also takes the raw graph's partition and plan
    for affinity routes that its trainer never selects; the port keeps
    those ops, ``affinity_halo`` and ``affinity_halo_bcsr``, in
    ``spmm_shard`` only.)"""
    ops = ShardOps(mesh, _halo_mm(part, plan, mesh, tiles, ells))
    return sharded_ggad_losses(params, ops, part, ax, seed_idx, normal_idx,
                               noise, seed_rows, aff_sub,
                               confidence_margin=confidence_margin,
                               pos_weight=pos_weight)


def halo_ggad_eval_scores(params: Params, part: EdgePartition,
                          plan: HaloPlan, ax: torch.Tensor, mesh,
                          tiles: Optional[HaloBCSR] = None,
                          ells: Optional[HaloELL] = None) -> torch.Tensor:
    """The eval branch on the halo exchange: one one-class logit per node,
    the replicated ``[D·R]`` (``halo_trainer.py:176-213``)."""
    ops = ShardOps(mesh, _halo_mm(part, plan, mesh, tiles, ells))
    return sharded_ggad_scores(params, ops, ax)


@dataclasses.dataclass
class HaloSetup:
    """Everything a halo step reads, placed on the mesh
    (``halo_trainer.py:281-295``). ``route`` is the per-shard product's:
    ``"bcsr"``, ``"ell"`` or ``"coo"``. JAX's setup also carries the
    padded features, the raw graph's partition and plan and its tile
    sets, which its step never reads beside the hoisted Â·x and the
    margin subset; the port does not keep them."""

    part: EdgePartition
    plan: HaloPlan
    ax: torch.Tensor                  # Â·x (the hoisted layer 1)
    seed_idx: NodeIndex
    normal_idx: NodeIndex
    seed_rows: HaloSeedRows
    aff_sub: HaloAffinitySubset
    route: str
    tiles: Optional[HaloBCSR] = None
    ells: Optional[HaloELL] = None

    def losses(self, params: Params, noise: torch.Tensor, mesh, *,
               confidence_margin: float = 0.7,
               pos_weight: float = 1.0) -> GGADLosses:
        """:func:`halo_ggad_forward_and_losses` on this setup."""
        return halo_ggad_forward_and_losses(
            params, self.part, self.plan, self.ax, self.seed_idx,
            self.normal_idx, noise, self.seed_rows, self.aff_sub, mesh,
            tiles=self.tiles, ells=self.ells,
            confidence_margin=confidence_margin, pos_weight=pos_weight)

    def scores(self, params: Params, mesh) -> torch.Tensor:
        """:func:`halo_ggad_eval_scores` on this setup (no gradient)."""
        with torch.no_grad():
            return halo_ggad_eval_scores(params, self.part, self.plan,
                                         self.ax, mesh, tiles=self.tiles,
                                         ells=self.ells)


def prepare_halo(dataset, mesh, spmm_impl: str = "auto",
                 spmm_dtype: str = "float32",
                 schedule: str = "dense") -> HaloSetup:
    """Partition and plan the normalized graph, build the route's
    per-shard structures, the seed rows and the margin subset (on the raw
    graph's partition), and place what ``mesh`` owns on its device
    (``halo_trainer.py:298-383``). ``spmm_impl`` and ``spmm_dtype`` are
    the single-device trainer's; ``schedule`` is ``"dense"``, ``"ring"``
    or ``"sched"``. The hoisted Â·x is one halo SpMM of the features (on
    the BCSR route, 2 K1 launches a shard at the feature width)."""
    from ggad_tpu_torch.train.full_batch import spmm_route

    g = from_scipy(dataset.adj, device="cpu")
    adj, raw_adj = normalize_adj_reference(g)
    route = spmm_route(adj, spmm_impl, dtype=spmm_dtype)
    D = mesh.n_shards
    part = partition_edges(adj, D)
    plan = build_halo_plan(part, schedule=schedule)
    seed_rows = place_halo_seed_rows(
        build_halo_seed_rows(part, dataset.abnormal_label_idx), mesh)
    labeled = np.concatenate([
        np.asarray(dataset.normal_label_idx, np.int64),
        np.asarray(dataset.abnormal_label_idx, np.int64)])
    tiles = ells = None
    if route == "bcsr":
        tiles_host = build_halo_bcsr(part, plan, dtype=spmm_dtype,
                                     mem_budget_bytes=BCSR_BUDGET_BYTES)
        if tiles_host is None:
            route = "ell"
        else:
            tiles = place_halo_bcsr(tiles_host, mesh)
    if route == "ell":
        ells = place_halo_ell(build_halo_ell(part, plan, dtype=spmm_dtype),
                              mesh)
    # the margin subset: rect tiles (K2) on the BCSR route; U ≤ 64K
    # bounds the [R × U] store (halo_trainer.py:350-360)
    sub_dtype = (spmm_dtype if (tiles is not None
                                and len(np.unique(labeled)) <= 65536)
                 else None)
    aff_sub = place_halo_affinity_subset(build_halo_affinity_subset(
        partition_edges(raw_adj, D), labeled, tiles_dtype=sub_dtype), mesh)
    R = part.rows_per_shard
    x_pad = place_nodes(pad_nodes(torch.as_tensor(
        np.asarray(dataset.features, np.float32)), part), mesh)
    part, plan = place_partition(part, mesh), place_halo_plan(plan, mesh)
    with torch.no_grad():
        ax = _halo_mm(part, plan, mesh, tiles, ells)(x_pad)
    return HaloSetup(
        part=part, plan=plan, ax=ax,
        seed_idx=node_index(dataset.abnormal_label_idx, R, mesh),
        normal_idx=node_index(dataset.normal_label_idx, R, mesh),
        seed_rows=seed_rows, aff_sub=aff_sub, route=route, tiles=tiles,
        ells=ells)


def halo_training_run(mesh, dataset, *, n_h: int = 64, lr: float = 1e-3,
                      noise_mean: float = 0.02, noise_std: float = 0.01,
                      seed: int = 0, n_steps: int = 1,
                      spmm_impl: str = "auto", spmm_dtype: str = "float32",
                      schedule: str = "dense",
                      generator: Optional[torch.Generator] = None,
                      device=None):
    """Build and run the halo training loop (``halo_trainer.py:386-425``):
    ``FullBatchTrainer(mesh=mesh)`` (:func:`prepare_halo` and its train
    step) from the port's init seeded with ``seed``, ``n_steps`` Adam steps with the noise drawn from
    ``generator`` (default: one on the mesh's device seeded with ``seed``,
    as ``train()`` seeds it). Returns ``(params, losses)``: the final
    ``state_dict`` and the last step's losses. ``mesh`` is a shard count
    (the local communicator on ``device``) or a 1-D communicator;
    ``spmm_impl`` is the trainer's (``"auto"`` routes by the graph). JAX's
    ``steps_per_dispatch`` has no counterpart: the steps run one after
    another and nothing is read between them."""
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    tr = FullBatchTrainer(dataset, lr=lr, embedding_dim=n_h,
                          noise_mean=noise_mean, noise_std=noise_std,
                          seed=seed, spmm_impl=spmm_impl,
                          spmm_dtype=spmm_dtype, device=device, mesh=mesh,
                          dist_schedule=schedule)
    tr.model.load_state_dict(tr.initial_state())
    if generator is None:
        generator = torch.Generator(tr.device).manual_seed(seed)
    losses = None
    for _ in range(n_steps):
        losses = tr.train_step(generator)
    return tr.params(), losses
