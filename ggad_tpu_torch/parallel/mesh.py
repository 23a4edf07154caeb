"""The shards of the multi-device paths and the collectives between them
(counterpart of ``ggad_tpu/parallel/mesh.py`` and of the ``jax.lax``
collectives in the ``shard_map`` bodies of ``parallel/spmm_shard.py``).

A sharded node array is a tensor whose leading axis holds the shards this
process owns (``mesh.shards``, their global ids in order):

  * :class:`LocalMesh` owns all D shards, in one process on one device.
    It is the counterpart of the JAX package's virtual 8-device CPU mesh,
    and the way D shards share one card;
  * :class:`DistMesh` owns one shard, that of its rank in an initialized
    ``torch.distributed`` process group of world size D.

A replicated value carries no shard axis. The halo ops are written once,
over the owned-shard axis, and call the mesh's collectives:

  * ``all_to_all(x, dim=0)``: ``x [n, D, ...]``, out ``[n, D, ...]`` with
    ``out[d][s] = x[s][d]`` (``lax.all_to_all`` tiled on per-shard dim
    ``dim``, here 0);
  * ``ppermute(x, dest)``: shard s's block goes to shard ``dest[s]``;
  * ``psum(x)``: ``[n, ...]`` → the replicated sum over all D shards;
  * ``all_gather(x, dim=0)``: ``[n, R, ...]`` → the replicated
    ``[D·R, ...]`` (the shards concatenated along per-shard dim ``dim``);
  * ``pvary(t)``: a replicated tensor about to enter per-shard compute;
  * ``barrier()``: every rank waits for the others (a no-op locally).

Gradients follow JAX's replication typing, made explicit. Every rank
computes the same replicated loss, so the cotangent of a replicated value
is the same on every rank: ``psum``'s backward is the identity and
``all_gather``'s takes the shard's slice. Per-shard compute yields only
its shard's part of a replicated input's cotangent: ``pvary``'s backward
sums the parts (an all-reduce). The halo ops and the trainer pass every
replicated tensor that enters per-shard compute through ``pvary``, so each
replicated parameter's gradient is all-reduced exactly once and equals the
single-device gradient. (``torch.distributed.nn.functional.all_reduce``
all-reduces in its backward too; under a replicated loss that would give
D times the gradient.) On a :class:`LocalMesh` every collective is a
tensor operation on the shard axis, autograd sums the parts itself and
``pvary`` is the identity.

**Named axes.** ``make_mesh(n, axis_names=(a0, a1), shape=(n_0, n_1))``
gives a :class:`Mesh2D` over the shards ``(i, j)`` of an ``[n_0, n_1]``
grid, numbered row-major (JAX's ``make_mesh(n, axis_names, shape)``): the
GSPMD path's ``('nodes', 'model')`` and the hybrid ``('hosts', 'nodes')``
of ``parallel.multihost``. Each axis is a 1-D communicator of its own,
``mesh.axis(name)``, over the shards that differ only in that coordinate
(locally a :class:`LocalMesh` of ``n_k`` shards; on ranks one
``torch.distributed`` group per row and per column of the rank grid), and
the 1-D code above runs on it unchanged. The mesh's own ops take a block
``[A, B, ...]`` (the owned coordinates on each axis; 1 where the value is
replicated over that axis) and an ``axis``: ``psum``, ``all_gather``,
``pvary``, ``all_to_all`` and ``ppermute`` over that axis keep a size-1
dim there, and with ``axis=None`` they run over the whole mesh
(``mesh.flat``, the row-major 1-D communicator over all its shards) as the
1-D ops do. The gradient rule is the 1-D one, on the axis's group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ggad_tpu_torch.device import DeviceLike, resolve_device

COMMS = ("local", "dist")


def _inverse(dest: list) -> list:
    src = [0] * len(dest)
    for s, d in enumerate(dest):
        src[d] = s
    return src


def _per_shard_dim(dim: int) -> int:
    """A per-shard dim as a dim of the block, whose dim 0 is the shard
    axis."""
    return dim + 1 if dim >= 0 else dim


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """D shards in this process, on ``device``."""

    n_shards: int
    device: torch.device

    @property
    def shards(self) -> list:
        return list(range(self.n_shards))

    def all_to_all(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x.transpose(0, _per_shard_dim(dim))

    def ppermute(self, x: torch.Tensor, dest: list) -> torch.Tensor:
        return x[_inverse(dest)]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if dim == 0:
            return x.reshape((-1,) + tuple(x.shape[2:]))
        return torch.cat(x.unbind(0), dim)

    def pvary(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def barrier(self) -> None:
        pass


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all of ``x [D, ...]`` in ``group``; it is its own
    inverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def _send_recv(x: torch.Tensor, dest: list, rank: int, ranks: list,
               group) -> torch.Tensor:
    if dest[rank] == rank:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[dest[rank]], group),
           dist.P2POp(dist.irecv, out, ranks[_inverse(dest)[rank]], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """This member's block to member ``dest[rank]`` of ``group`` (global
    ranks ``ranks``); backward: the inverse permutation."""

    @staticmethod
    def forward(ctx, x, dest, rank, ranks, group):
        ctx.dest, ctx.rank, ctx.ranks, ctx.group = dest, rank, ranks, group
        return _send_recv(x, dest, rank, ranks, group)

    @staticmethod
    def backward(ctx, g):
        return (_send_recv(g, _inverse(ctx.dest), ctx.rank, ctx.ranks,
                           ctx.group), None, None, None, None)


class _PSum(torch.autograd.Function):
    """All-reduce in ``group`` to a replicated value; backward: the
    identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    """The identity; backward: all-reduce the per-shard cotangents in
    ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """``x`` on each member of ``group`` → the replicated concatenation
    along ``dim``; backward: this member's slice of the replicated
    cotangent."""

    @staticmethod
    def forward(ctx, x, n_shards, rank, group, dim):
        ctx.rank, ctx.size, ctx.dim = rank, x.shape[dim], dim
        parts = [torch.empty_like(x) for _ in range(n_shards)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None,
                None, None)


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """One shard, member ``rank`` of a process group of ``n_shards`` ranks
    (gloo on CPU tensors, NCCL on CUDA ones): the default group, or
    ``group``, whose members are the global ranks ``ranks`` in order (one
    axis of a :class:`Mesh2D`)."""

    n_shards: int
    device: torch.device
    rank: int
    group: Optional[object] = None
    ranks: Optional[tuple] = None

    @property
    def shards(self) -> list:
        return [self.rank]

    def _ranks(self) -> list:
        return list(self.ranks or range(self.n_shards))

    def all_to_all(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        y = _AllToAll.apply(x[0].movedim(dim, 0), self.group)
        return y.movedim(0, dim)[None]

    def ppermute(self, x: torch.Tensor, dest: list) -> torch.Tensor:
        return _PPermute.apply(x[0], list(dest), self.rank, self._ranks(),
                               self.group)[None]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x[0], self.group)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return _AllGather.apply(x[0], self.n_shards, self.rank, self.group,
                                dim)

    def pvary(self, t: torch.Tensor) -> torch.Tensor:
        return _PVary.apply(t, self.group)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """Shards ``(i, j)`` of an ``[n_0, n_1]`` grid with named axes: one
    1-D communicator an axis (``views``) and one over the whole mesh
    (``flat``, row-major). Its ops take ``[A, B, ...]`` blocks."""

    axis_names: tuple
    shape: tuple
    views: tuple
    flat: object

    @property
    def n_shards(self) -> int:
        return self.flat.n_shards

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def shards(self) -> list:
        return self.flat.shards

    @property
    def rank(self) -> int:
        return getattr(self.flat, "rank", 0)

    def _k(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        return self.axis_names.index(axis)

    def axis(self, name: str):
        """The 1-D communicator over axis ``name``."""
        return self.views[self._k(name)]

    def psum(self, x: torch.Tensor, axis: Optional[str] = None
             ) -> torch.Tensor:
        if axis is None:
            return self.flat.psum(x.flatten(0, 1))
        k = self._k(axis)
        return self.views[k].psum(x.movedim(k, 0)).unsqueeze(k)

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None,
                   dim: int = 0) -> torch.Tensor:
        if axis is None:
            return self.flat.all_gather(x.flatten(0, 1), dim)
        k = self._k(axis)
        return self.views[k].all_gather(
            x.movedim(k, 0), _per_shard_dim(dim)).unsqueeze(k)

    def pvary(self, t: torch.Tensor, axis: Optional[str] = None
              ) -> torch.Tensor:
        comm = self.flat if axis is None else self.axis(axis)
        return comm.pvary(t)

    def all_to_all(self, x: torch.Tensor, axis: Optional[str] = None,
                   dim: int = 0) -> torch.Tensor:
        if axis is None:
            return self.flat.all_to_all(x.flatten(0, 1), dim).reshape(
                x.shape)
        k = self._k(axis)
        return self.views[k].all_to_all(
            x.movedim(k, 0), _per_shard_dim(dim)).movedim(0, k)

    def ppermute(self, x: torch.Tensor, dest: list,
                 axis: Optional[str] = None) -> torch.Tensor:
        if axis is None:
            return self.flat.ppermute(x.flatten(0, 1), dest).reshape(
                x.shape)
        k = self._k(axis)
        return self.views[k].ppermute(x.movedim(k, 0), dest).movedim(0, k)

    def barrier(self) -> None:
        self.flat.barrier()


def _dist_mesh_2d(axis_names: tuple, shape: tuple,
                  device: torch.device) -> Mesh2D:
    """This rank's :class:`Mesh2D`: rank r is shard ``divmod(r, n_1)``;
    every rank creates every row and column group, in one order."""
    n0, n1 = shape
    rank = dist.get_rank()
    views = [None, None]
    for k, (n_groups, size) in enumerate(((n1, n0), (n0, n1))):
        for g in range(n_groups):
            ranks = tuple(m * n1 + g if k == 0 else g * n1 + m
                          for m in range(size))
            group = dist.new_group(list(ranks))
            if rank in ranks:
                views[k] = DistMesh(size, device, ranks.index(rank), group,
                                    ranks)
    return Mesh2D(tuple(axis_names), tuple(shape), tuple(views),
                  DistMesh(n0 * n1, device, rank))


def make_mesh(n_shards: int, comm: str = "local",
              device: DeviceLike = None, *,
              axis_names: Sequence[str] = ("nodes",),
              shape: Optional[Sequence[int]] = None):
    """The shards of a multi-device run: ``"local"`` holds all
    ``n_shards`` in this process on ``device`` (the card by default) and
    never starts a rank; ``"dist"`` holds this rank's shard and needs an
    initialized ``torch.distributed`` process group of world size
    ``n_shards`` (it raises otherwise, and never drops to ``"local"``).
    ``shape`` of two axes (product ``n_shards``) with two ``axis_names``
    gives a :class:`Mesh2D`; otherwise the mesh is 1-D."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be ≥ 1, got {n_shards}")
    shape = tuple(shape) if shape is not None else (n_shards,)
    if len(shape) not in (1, 2) or len(axis_names) != len(shape):
        raise ValueError(f"shape {shape} and axis_names {tuple(axis_names)} "
                         f"must both have 1 or 2 entries")
    if int(torch.tensor(shape).prod()) != n_shards:
        raise ValueError(f"shape {shape} does not hold {n_shards} shards")
    device = resolve_device(device)
    if comm not in COMMS:
        raise ValueError(f"comm must be one of {COMMS}, got {comm!r}")
    if comm == "local":
        if len(shape) == 1:
            return LocalMesh(n_shards, device)
        return Mesh2D(tuple(axis_names), shape,
                      tuple(LocalMesh(n, device) for n in shape),
                      LocalMesh(n_shards, device))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("comm='dist' needs an initialized "
                           "torch.distributed process group")
    if dist.get_world_size() != n_shards:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not n_shards={n_shards}")
    if len(shape) == 1:
        return DistMesh(n_shards, device, dist.get_rank())
    return _dist_mesh_2d(tuple(axis_names), shape, device)
