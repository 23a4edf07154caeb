"""The shards of the halo path and the collectives between them
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

  * ``all_to_all(x)``: ``x [n, D, ...]``, out ``[n, D, ...]`` with
    ``out[d][s] = x[s][d]`` (``lax.all_to_all`` tiled on axis 0);
  * ``ppermute(x, dest)``: shard s's block goes to shard ``dest[s]``;
  * ``psum(x)``: ``[n, ...]`` → the replicated sum over all D shards;
  * ``all_gather(x)``: ``[n, R, ...]`` → the replicated ``[D·R, ...]``;
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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ggad_tpu_torch.device import DeviceLike, resolve_device

COMMS = ("local", "dist")


def _inverse(dest: list) -> list:
    src = [0] * len(dest)
    for s, d in enumerate(dest):
        src[d] = s
    return src


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """D shards in this process, on ``device``."""

    n_shards: int
    device: torch.device

    @property
    def shards(self) -> list:
        return list(range(self.n_shards))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1)

    def ppermute(self, x: torch.Tensor, dest: list) -> torch.Tensor:
        return x[_inverse(dest)]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def pvary(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def barrier(self) -> None:
        pass


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all of ``x [D, ...]``; it is its own inverse."""

    @staticmethod
    def forward(ctx, x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g)


def _send_recv(x: torch.Tensor, dest: list, rank: int) -> torch.Tensor:
    if dest[rank] == rank:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dest[rank]),
           dist.P2POp(dist.irecv, out, _inverse(dest)[rank])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """This rank's block to rank ``dest[rank]``; backward: the inverse
    permutation."""

    @staticmethod
    def forward(ctx, x, dest, rank):
        ctx.dest, ctx.rank = dest, rank
        return _send_recv(x, dest, rank)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, _inverse(ctx.dest), ctx.rank), None, None


class _PSum(torch.autograd.Function):
    """All-reduce to a replicated value; backward: the identity."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _PVary(torch.autograd.Function):
    """The identity; backward: all-reduce the per-shard cotangents."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _AllGather(torch.autograd.Function):
    """``[R, ...]`` on each rank → the replicated ``[D·R, ...]``;
    backward: this rank's slice of the replicated cotangent."""

    @staticmethod
    def forward(ctx, x, n_shards, rank):
        ctx.rank, ctx.rows = rank, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(n_shards)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """One shard, that of ``rank``, of a process group of world size
    ``n_shards`` (gloo on CPU tensors, NCCL on CUDA ones)."""

    n_shards: int
    device: torch.device
    rank: int

    @property
    def shards(self) -> list:
        return [self.rank]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return _AllToAll.apply(x[0])[None]

    def ppermute(self, x: torch.Tensor, dest: list) -> torch.Tensor:
        return _PPermute.apply(x[0], list(dest), self.rank)[None]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x[0])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return _AllGather.apply(x[0], self.n_shards, self.rank)

    def pvary(self, t: torch.Tensor) -> torch.Tensor:
        return _PVary.apply(t)

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(n_shards: int, comm: str = "local",
              device: DeviceLike = None):
    """The shards of a halo run: ``"local"`` holds all ``n_shards`` in
    this process on ``device`` (the card by default) and never starts a
    rank; ``"dist"`` holds this rank's shard and needs an initialized
    ``torch.distributed`` process group of world size ``n_shards`` (it
    raises otherwise, and never drops to ``"local"``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be ≥ 1, got {n_shards}")
    device = resolve_device(device)
    if comm == "local":
        return LocalMesh(n_shards, device)
    if comm != "dist":
        raise ValueError(f"comm must be one of {COMMS}, got {comm!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("comm='dist' needs an initialized "
                           "torch.distributed process group")
    if dist.get_world_size() != n_shards:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not n_shards={n_shards}")
    return DistMesh(n_shards, device, dist.get_rank())
