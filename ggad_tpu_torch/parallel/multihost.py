"""Multi-host (multi-process) runs (counterpart of
``ggad_tpu/parallel/multihost.py``).

One host's shards ride its own links; past a host, ranks meet over the
network. This module wraps the three pieces a multi-host run needs:

  * :func:`initialize`: ``torch.distributed.init_process_group`` from the
    arguments or from ``torchrun``'s environment; a no-op when already
    initialized or when run as one process with no arguments;
  * :func:`make_hybrid_mesh`: a 2-D ``parallel.mesh.Mesh2D`` whose outer
    axis spans hosts and whose inner axis the ranks of one host, ranks
    grouped ``[hosts, per_host]`` in rank order (one ``torch.distributed``
    group per host and per inner coordinate);
  * :func:`host_local_batch`: each process keeps its own slice of the
    data-parallel batch axis.

In one process everything degenerates: the hybrid mesh is ``[1, n]``
local shards and a process's batch is the whole batch. Nothing here
falls back quietly: a ``"dist"`` mesh still needs an initialized group.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.parallel.mesh import Mesh2D, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> None:
    """Join the process group unless already joined or single-process;
    safe to call unconditionally at program start. ``coordinator_address``
    is ``host:port`` of rank 0; without arguments ``torchrun``'s
    ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` are
    read, and a world of one (or none) stays one process. ``backend``:
    NCCL when a card is present, gloo otherwise, unless given.

    The already-joined check comes first and touches no CUDA state (JAX's
    note, ``multihost.py:42-46``: a backend started first rejects a later
    distributed init)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def make_hybrid_mesh(ici_axis: str = "nodes", dcn_axis: str = "hosts",
                     per_host_parallelism: Optional[int] = None,
                     device: DeviceLike = None) -> Mesh2D:
    """The mesh ``[hosts, per_host]``: outer axis ``dcn_axis`` over hosts,
    inner ``ici_axis`` over one host's ranks, on ``device`` (the card by
    default; a rank's ``cuda:LOCAL_RANK`` under ``torchrun``). With a
    process group, ``per_host`` is ``per_host_parallelism``, else
    ``LOCAL_WORLD_SIZE``, else 1 (each process its own host). In one
    process it is ``[1, n]`` local shards, ``n`` = ``per_host_parallelism``
    or the card count (1 on the CPU)."""
    axes = (dcn_axis, ici_axis)
    if not dist.is_initialized():
        device = resolve_device(device)
        n = per_host_parallelism or (torch.cuda.device_count()
                                     if device.type == "cuda" else 1)
        return make_mesh(n, device=device, axis_names=axes, shape=(1, n))
    world = dist.get_world_size()
    per_host = per_host_parallelism or int(
        os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if world % per_host:
        raise ValueError(f"{world} ranks do not group into hosts of "
                         f"{per_host}")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return make_mesh(world, comm="dist", device=device, axis_names=axes,
                     shape=(world // per_host, per_host))


def host_local_batch(mesh, local_ids, axis: str = "batch") -> torch.Tensor:
    """This process's part of a batch-sharded id array, on the mesh's
    device: each process passes its own slice ``[per_host, ...]`` of the
    global ``[world · per_host, ...]`` batch, in rank order, which is the
    contiguous slice the data-parallel step gives its shard
    (``parallel.minibatch_dp``). In one process it is the ids themselves.
    On a :class:`Mesh2D` ``axis`` names the batch axis, and the global
    batch must split evenly over it."""
    local = torch.as_tensor(np.ascontiguousarray(local_ids))
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = mesh.axis(axis).n_shards if isinstance(mesh, Mesh2D) \
        else mesh.n_shards
    if (local.shape[0] * world) % n:
        raise ValueError(f"a global batch of {local.shape[0] * world} does "
                         f"not split over {n} shards")
    return local.to(mesh.device)
