"""``parallel.multihost`` against ``ggad_tpu.parallel.multihost``, and two
processes against one.

  * One process: the hybrid mesh's axes and shape and
    ``host_local_batch``'s round trips equal JAX's
    (``tests/test_multihost.py:11-38``); ``initialize()`` with no
    arguments and no ``torchrun`` stays one process.
  * Two gloo processes (``tests/torch_multihost_worker.py``, each
    standing for a host): ``initialize`` and ``make_hybrid_mesh`` →
    ``[2, 1]``; a ring round over ``'hosts'`` and a ``psum`` over
    ``'nodes'``; ``host_local_batch`` (each rank's slice, all-gathered to
    the global batch); one data-parallel minibatch step, one GSPMD step
    and the 2-D tensor-parallel losses on a ``(1, 2)`` mesh, each equal to
    the same on the one-process local communicator: losses to 1e-6,
    gradients and parameters after the step to 1e-5 (a gradient
    all-reduced twice would be twice too large and shows in the
    gradients; Adam's step would hide it in the parameters).
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch_multihost_worker as worker

from ggad_tpu.parallel.multihost import host_local_batch as \
    jax_host_local_batch
from ggad_tpu.parallel.multihost import make_hybrid_mesh as jax_hybrid
from ggad_tpu_torch.parallel.mesh import make_mesh
from ggad_tpu_torch.parallel.multihost import (
    host_local_batch,
    initialize,
    make_hybrid_mesh,
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hybrid_mesh_single_process_shape():
    jm = jax_hybrid()
    mesh = make_hybrid_mesh(per_host_parallelism=len(jax.devices()),
                            device="cpu")
    assert mesh.axis_names == jm.axis_names == ("hosts", "nodes")
    assert mesh.shape == tuple(jm.devices.shape) == (1, 8)
    assert make_hybrid_mesh(device="cpu").shape == (1, 1)


@pytest.mark.parametrize("n_shards,shape", [(8, (32,)), (4, (8, 3))])
def test_host_local_batch_roundtrip(n_shards, shape):
    from jax.sharding import Mesh

    ids = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    expect = np.asarray(jax_host_local_batch(
        Mesh(np.asarray(jax.devices()[:n_shards]), ("batch",)), ids,
        axis="batch"))
    got = host_local_batch(make_mesh(n_shards, device="cpu"), ids,
                           axis="batch")
    assert tuple(got.shape) == expect.shape == shape
    np.testing.assert_array_equal(got.numpy(), expect)
    with pytest.raises(ValueError, match="split"):
        host_local_batch(make_mesh(3, device="cpu"), ids)


def test_initialize_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh(2, comm="dist", device="cpu")


def test_mesh_2d_local_ops():
    """``Mesh2D``'s per-axis and whole-mesh ops on a local ``(2, 3)``
    block, against the plain tensor algebra they stand for."""
    mesh = make_mesh(6, device="cpu", axis_names=("nodes", "model"),
                     shape=(2, 3))
    x = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(mesh.psum(x, axis="model"),
                               x.sum(1, keepdim=True))
    torch.testing.assert_close(mesh.psum(x, axis="nodes"),
                               x.sum(0, keepdim=True))
    torch.testing.assert_close(mesh.psum(x), x.sum((0, 1)))
    torch.testing.assert_close(mesh.all_gather(x, axis="model", dim=-1),
                               torch.cat(x.unbind(1), -1)[:, None])
    torch.testing.assert_close(mesh.all_gather(x, axis="nodes"),
                               torch.cat(x.unbind(0), 1)[None])
    torch.testing.assert_close(mesh.all_gather(x), x.reshape(18, 4))
    a2a = mesh.all_to_all(x, axis="model")
    for s in range(3):
        for d in range(3):
            torch.testing.assert_close(a2a[:, d, s], x[:, s, d])
    torch.testing.assert_close(mesh.ppermute(x, [1, 2, 0], axis="model"),
                               x[:, [2, 0, 1]])
    assert mesh.axis("model").n_shards == 3 and mesh.pvary(x) is x
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis("hosts")
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(6, device="cpu", axis_names=("a", "b"), shape=(2, 2))


def assert_step(got: dict, ref: dict, what: str) -> None:
    torch.testing.assert_close(got["losses"], ref["losses"], rtol=1e-6,
                               atol=1e-6, msg=what)
    for key in ("grads", "params"):
        assert got[key].keys() == ref[key].keys()
        for k, v in ref[key].items():
            torch.testing.assert_close(got[key][k], v, rtol=1e-5,
                                       atol=1e-5, msg=f"{what} {key} {k}")
    torch.testing.assert_close(got["scores"], ref["scores"], rtol=1e-5,
                               atol=1e-5, msg=what)


def test_two_processes_match_one(tmp_path):
    world = 2
    mp.spawn(worker.run, args=(world, free_port(), str(tmp_path)),
             nprocs=world, join=True)
    local = make_mesh(world, device="cpu")
    dp, gspmd = worker.dp_case(local), worker.gspmd_case(local)
    tp = worker.tp_case(make_mesh(world, device="cpu",
                                  axis_names=("nodes", "model"),
                                  shape=(1, world)))
    assert tp["sharded"]
    blocks = torch.arange(world * world * 3.0).view(1, world, world, 3)
    ops = worker.mesh_ops_case(make_mesh(world, device="cpu",
                                         axis_names=("nodes", "model"),
                                         shape=(1, world)), blocks)
    rows = [torch.arange(3.0) + 10 * r for r in range(world)]
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["hybrid"] == (("hosts", "nodes"), (world, 1))
        for k in ("psum", "gather"):      # replicated over 'model'
            torch.testing.assert_close(got["ops"][k], ops[k])
        torch.testing.assert_close(got["ops"]["a2a"], ops["a2a"][:, r:r + 1])
        torch.testing.assert_close(got["ops"]["whole"], ops["whole"])
        torch.testing.assert_close(got["round"][0, 0],
                                   rows[r] + rows[(r - 1) % world])
        np.testing.assert_array_equal(got["local"].numpy(),
                                      np.arange(8) + 100 * r)
        np.testing.assert_array_equal(
            got["batch"].numpy(),
            np.concatenate([np.arange(8) + 100 * h for h in range(world)]))
        assert_step(got["dp"], dp, "dp")
        assert_step(got["gspmd"], gspmd, "gspmd")
        torch.testing.assert_close(got["tp"]["losses"], tp["losses"],
                                   rtol=1e-6, atol=1e-6)
        for k, g in tp["grads"].items():
            ref = g[r:r + 1] if k in tp["sharded"] else g
            torch.testing.assert_close(got["tp"]["grads"][k], ref,
                                       rtol=1e-5, atol=1e-5, msg=f"tp {k}")

