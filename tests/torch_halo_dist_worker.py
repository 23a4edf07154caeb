"""One rank of ``tests/test_torch_halo_dist.py``: the halo path on the
``"dist"`` communicator (gloo, CPU). Rank r builds the same seeded graph,
weights and inputs as the test's local run, computes its shard of
``spmm_halo_bcsr`` and the gradient of a sharded loss, then one training
step through ``FullBatchTrainer(mesh=...)``, and saves what it got to
``out_dir/rank{r}.pt``. Imported by the spawned ranks, never collected.
"""

import numpy as np
import torch
import torch.distributed as dist

N_H = 16
DS_KW = dict(n_nodes=200, avg_degree=8, feat_dim=16, n_communities=3,
             anomaly_rate=0.1, seed=5)


def dataset():
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad

    return synthetic_gad(**DS_KW)


def spmm_case(mesh, schedule: str):
    """``spmm_halo_bcsr`` of a seeded h on the normalized adjacency and
    d(Σ out·w)/dh, both ``[n, R, d]`` for the shards ``mesh`` owns."""
    from ggad_tpu_torch.graph import from_scipy
    from ggad_tpu_torch.ops.normalize import normalize_adj_reference
    from ggad_tpu_torch.parallel import spmm_shard as ss

    ds = dataset()
    adj, _ = normalize_adj_reference(from_scipy(ds.adj, device="cpu"))
    part = ss.partition_edges(adj, mesh.n_shards)
    plan = ss.build_halo_plan(part, schedule)
    tiles = ss.place_halo_bcsr(ss.build_halo_bcsr(part, plan), mesh)
    rng = np.random.default_rng(0)
    h_full = ss.pad_nodes(torch.from_numpy(
        rng.normal(size=(ds.n_nodes, 12)).astype(np.float32)), part)
    w_full = torch.from_numpy(
        rng.normal(size=tuple(h_full.shape)).astype(np.float32))
    part, plan = ss.place_partition(part, mesh), ss.place_halo_plan(plan,
                                                                   mesh)
    h = ss.place_nodes(h_full, mesh).requires_grad_(True)
    out = ss.spmm_halo_bcsr(part, plan, tiles, h, mesh)
    (out * ss.place_nodes(w_full, mesh)).sum().backward()
    return out.detach(), h.grad


def step_case(mesh, schedule: str):
    """One Adam step of the halo trainer from the seeded init with a
    fixed noise: the losses, every parameter's gradient, the parameters
    after the step and the scores after it."""
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    tr = FullBatchTrainer(dataset(), embedding_dim=N_H, spmm_impl="bcsr",
                          noise_mean=0.02, noise_std=0.01, lr=5e-3,
                          mesh=mesh, dist_schedule=schedule, device="cpu")
    tr.model.load_state_dict(tr.init())
    noise = tr.draw_noise(torch.Generator().manual_seed(3))
    tr.optimizer = tr.make_optimizer()
    tr.optimizer.zero_grad(set_to_none=True)
    losses = tr.compute_losses(noise)
    losses.total.backward()
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()}
    tr.optimizer.step()
    return {"losses": torch.stack([t.detach() for t in losses]),
            "grads": grads, "params": tr.params(),
            "scores": torch.from_numpy(tr.eval_scores())}


def run(rank: int, world: int, port: int, schedule: str, out_dir: str):
    from ggad_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(world, comm="dist", device="cpu")
        out, grad = spmm_case(mesh, schedule)
        torch.save({"spmm": out, "spmm_grad": grad,
                    **step_case(mesh, schedule)},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
