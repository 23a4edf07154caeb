"""One rank of ``tests/test_torch_multihost.py``: two gloo processes on
the CPU stand for two hosts. Rank r joins the group through
``parallel.multihost.initialize``, builds the hybrid mesh and its own
slice of a batch, runs a collective round on the hybrid mesh, then one
data-parallel minibatch step, one GSPMD step and one 2-D
tensor-parallel step (a ``(1, 2)`` ``('nodes', 'model')`` mesh) on the
``"dist"`` communicator, and saves what it got to
``out_dir/rank{r}.pt``. The test runs the same cases on the local
communicator. Imported by the spawned ranks, never collected.
"""

import numpy as np
import scipy.sparse as sp
import torch

N_H = 16
DS_KW = dict(n_nodes=200, avg_degree=8, feat_dim=16, n_communities=3,
             anomaly_rate=0.1, seed=5)


def dataset():
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad

    return synthetic_gad(**DS_KW)


def _grads(named) -> dict:
    return {k: p.grad.clone() for k, p in named}


def dp_case(mesh) -> dict:
    """One AdamW step of ``MiniBatchTrainer(mesh=...)`` from the seeded
    init on a fixed batch and draws (B 16 + 8)."""
    from ggad_tpu_torch.datasets.splits import minibatch_split
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    ds = dataset()
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split(
        ds.ano_labels, seed=0, pseudo_anomaly_frac=0.1)
    tr = MiniBatchTrainer(
        adj=adj, features=ds.features, labels=labels, idx_train=idx_train,
        idx_anomaly=idx_anom, idx_valid=idx_valid, idx_test=idx_test,
        emb_dim=16, fanout1=4, fanout2=3, batch_size=16, n_anom_per_batch=8,
        num_batches=1, eval_batch=32, device="cpu", mesh=mesh)
    batch = tr.draw_batches(np.random.default_rng(1))[0]
    gen = torch.Generator().manual_seed(1)
    u1 = torch.rand(24, 4, generator=gen)
    u2 = torch.rand(96, 3, generator=gen)
    tr.optimizer = tr.make_optimizer()
    losses = tr.compute_losses(batch, u1, u2)
    losses.total.backward()
    grads = _grads(tr.model.named_parameters())
    tr.optimizer.step()
    return {"losses": torch.stack([t.detach() for t in losses]),
            "grads": grads, "params": tr.params(),
            "scores": torch.from_numpy(tr.score_nodes(None, idx_valid))}


def gspmd_case(mesh) -> dict:
    """One Adam step of ``FullBatchTrainer(dist_impl="gspmd")`` from the
    seeded init with a fixed noise."""
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    tr = FullBatchTrainer(dataset(), embedding_dim=N_H, noise_mean=0.02,
                          noise_std=0.01, lr=5e-3, mesh=mesh,
                          dist_impl="gspmd", device="cpu")
    tr.model.load_state_dict(tr.init())
    noise = tr.draw_noise(torch.Generator().manual_seed(3))
    tr.optimizer = tr.make_optimizer()
    losses = tr.compute_losses(noise)
    losses.total.backward()
    grads = _grads(tr.model.named_parameters())
    tr.optimizer.step()
    return {"losses": torch.stack([t.detach() for t in losses]),
            "grads": grads, "params": tr.params(),
            "scores": torch.from_numpy(tr.eval_scores())}


def tp_case(mesh2d) -> dict:
    """The 2-D forward and losses at the seeded init with a fixed noise,
    and each leaf's gradient (the owned blocks of the sharded ones)."""
    from ggad_tpu_torch.models.ggad import GGAD
    from ggad_tpu_torch.parallel.full_batch import (
        prepare_gspmd,
        shard_params_2d,
        tp_sharded,
    )

    ds = dataset()
    full = GGAD(ds.feat_dim, N_H,
                generator=torch.Generator().manual_seed(0)).state_dict()
    m = mesh2d.axis("model").n_shards
    sharded = frozenset(k for k, v in full.items() if tp_sharded(k, v, m))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in shard_params_2d(full, mesh2d).items()}
    noise = torch.randn(len(ds.abnormal_label_idx), N_H,
                        generator=torch.Generator().manual_seed(4))
    losses = prepare_gspmd(ds, mesh2d).losses(leaves, noise, mesh2d,
                                              sharded=sharded)
    losses.total.backward()
    return {"losses": torch.stack([t.detach() for t in losses]),
            "grads": _grads(leaves.items()), "sharded": sorted(sharded)}


def mesh_ops_case(mesh2d, blocks: torch.Tensor) -> dict:
    """Each per-axis op of a ``(1, n)`` ``('nodes', 'model')`` mesh on the
    owned part of ``blocks [1, n, n, 3]``."""
    j = mesh2d.axis("model").shards
    x = blocks[:, j]
    return {"psum": mesh2d.psum(x, axis="model"),
            "gather": mesh2d.all_gather(x, axis="model", dim=-1),
            "a2a": mesh2d.all_to_all(x, axis="model"),
            "whole": mesh2d.psum(x)}


def run(rank: int, world: int, port: int, out_dir: str):
    import torch.distributed as dist

    from ggad_tpu_torch.parallel.mesh import make_mesh
    from ggad_tpu_torch.parallel.multihost import (
        host_local_batch,
        initialize,
        make_hybrid_mesh,
    )

    torch.set_num_threads(1)
    initialize(coordinator_address=f"127.0.0.1:{port}",
               num_processes=world, process_id=rank, backend="gloo")
    try:
        initialize()                          # joined already: a no-op
        hybrid = make_hybrid_mesh(device="cpu")
        # a round on the hybrid mesh: ring over hosts, psum over nodes
        x = torch.arange(3.0)[None, None] + 10 * rank
        ring = [(h + 1) % world for h in range(world)]
        nxt = hybrid.ppermute(x, ring, axis="hosts")
        round_out = hybrid.psum(x + nxt, axis="nodes")
        flat = make_mesh(world, comm="dist", device="cpu")
        local = host_local_batch(flat, np.arange(8) + 100 * rank)
        batch = flat.all_gather(local[None])
        mesh2d = make_mesh(world, comm="dist", device="cpu",
                           axis_names=("nodes", "model"), shape=(1, world))
        blocks = torch.arange(world * world * 3.0).view(1, world, world, 3)
        torch.save({"ops": mesh_ops_case(mesh2d, blocks),
                    "hybrid": (hybrid.axis_names, hybrid.shape),
                    "round": round_out, "local": local, "batch": batch,
                    "dp": dp_case(flat), "gspmd": gspmd_case(flat),
                    "tp": tp_case(mesh2d)}, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
