"""Entry points of the port (counterparts of the root
``__graft_entry__.py``): a single-device forward with its example
arguments, and the multi-device dry run over every sharded path.

    python -c "from ggad_tpu_torch.entry import dryrun_multichip; \\
               dryrun_multichip(4)"          # on the card; device="cpu" here
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.graph import from_scipy
from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.models.ggad import GGAD
from ggad_tpu_torch.ops.normalize import normalize_adj_reference

N_H = 32                         # __graft_entry__.py:48 and on


def entry(initial_params: Optional[Any] = None, device: DeviceLike = None):
    """``(fn, args)``: GGAD's eval forward ``fn(params, adj, features)`` →
    logits ``[N, 1]`` on the 512-node synthetic graph at n_h 64, and its
    arguments (``__graft_entry__.py:7-34``). ``initial_params`` (a flax
    tree or a ``state_dict``), else the port's init seeded with 0."""
    device = resolve_device(device)
    ds = synthetic_gad(n_nodes=512, avg_degree=8, feat_dim=32, seed=0)
    adj, _ = normalize_adj_reference(from_scipy(ds.adj, device=device))
    features = torch.as_tensor(ds.features, dtype=torch.float32,
                               device=device)
    model = GGAD(ds.feat_dim, 64,
                 generator=torch.Generator().manual_seed(0)).to(device)
    params = (as_state_dict(initial_params, device)
              if initial_params is not None else dict(model.state_dict()))

    def fn(params, adj, features):
        with torch.no_grad():
            out = torch.func.functional_call(model, params, (adj, features),
                                             {"train": False})
        return out.logits

    return fn, (params, adj, features)


def _halo_losses(mesh, ds, schedule: str, spmm_impl: str) -> dict:
    """One halo step from the seeded init and noise: its loss and the K1
    and K2 launches of the leg (its preparation included)."""
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    k1, k2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
    tr = FullBatchTrainer(ds, mesh=mesh, dist_schedule=schedule,
                          spmm_impl=spmm_impl, embedding_dim=N_H,
                          noise_mean=0.02, noise_std=0.01,
                          device=mesh.device)
    tr.model.load_state_dict(tr.init())
    losses = tr.train_step(torch.Generator(tr.device).manual_seed(0))
    return {"loss": float(losses.total), "route": tr.route,
            "k1": bcsr_spmm.launches - k1,
            "k2": bcsr_sddmm_colsum.launches - k2}


def _close(got: float, ref: float, tol: float, what: str) -> None:
    if not abs(got - ref) <= tol * max(1.0, abs(ref)):
        raise AssertionError(f"{what} loss {got} != {ref} "
                             f"(tol {tol}·max(1, |ref|))")


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """One training step of every multi-device path over ``n_devices``
    shards of a local mesh on ``device`` (the card by default), with the
    assertions of ``__graft_entry__.py:37-144``: GSPMD (here also equal
    to the halo's dense wire from the same weights and noise); the halo on
    the dense, ring and sched wires (ring and sched within
    1e-5·max(1, |dense|) of dense); the halo on BCSR tiles with the sched
    wire (1e-4; K1 and K2 on the card); the halo on ELL tables (1e-4); 2-D
    ``('nodes', 'model')`` tensor parallelism at even ``n_devices``; and
    the data-parallel ``MiniBatchTrainer`` against the single-device one
    (2e-4). Returns each leg's loss; the halo legs also their route and
    launches of K1 and K2."""
    from ggad_tpu_torch.datasets.splits import minibatch_split
    from ggad_tpu_torch.parallel.full_batch import (
        sharded_train_step,
        sharded_train_step_2d,
    )
    from ggad_tpu_torch.parallel.mesh import make_mesh
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    n = n_devices
    mesh = make_mesh(n, device=device)
    dev = mesh.device
    ds = synthetic_gad(n_nodes=256, avg_degree=8, feat_dim=16, seed=0)
    out: dict = {}

    def report(leg: str, loss: float, note: str = "") -> None:
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite {leg} loss: {loss}")
        print(f"dryrun_multichip({n}): {leg} OK, loss={loss:.4f}{note}")

    for schedule in ("dense", "ring", "sched"):
        out[f"halo {schedule}"] = _halo_losses(mesh, ds, schedule, "coo")
    dense = out["halo dense"]["loss"]
    report("halo full-batch", dense)
    for schedule in ("ring", "sched"):
        got = out[f"halo {schedule}"]["loss"]
        _close(got, dense, 1e-5, f"{schedule}-halo")
        report(f"{schedule}-halo full-batch", got, " (== dense)")
    out["halo bcsr sched"] = _halo_losses(mesh, ds, "sched", "bcsr")
    out["halo ell"] = _halo_losses(mesh, ds, "dense", "ell")
    for leg in ("halo bcsr sched", "halo ell"):
        _close(out[leg]["loss"], dense, 1e-4, leg)
        report(leg, out[leg]["loss"], " (== dense)")

    noise = (torch.randn(len(ds.abnormal_label_idx), N_H,
                         generator=torch.Generator(dev).manual_seed(0),
                         device=dev) * 0.01 + 0.02)
    out["gspmd"] = sharded_train_step(mesh, ds, n_h=N_H, noises=[noise])
    _close(out["gspmd"], dense, 1e-5, "gspmd")
    report("full-batch (gspmd)", out["gspmd"], " (== dense halo)")

    if n % 2 == 0:
        mesh2d = make_mesh(n, device=dev, axis_names=("nodes", "model"),
                           shape=(n // 2, 2))
        out["2-D tp"] = sharded_train_step_2d(mesh2d, ds, n_h=N_H)
        report("2-D nodes×model TP", out["2-D tp"])

    # the data-parallel MiniBatchTrainer against the single-device one
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split(
        ds.ano_labels, seed=0, pseudo_anomaly_frac=0.1)
    per = max(8 // n, 1)
    kwargs = dict(
        adj=adj, features=ds.features, labels=labels,
        idx_train=idx_train, idx_anomaly=idx_anom, idx_valid=idx_valid,
        idx_test=idx_test, emb_dim=16, fanout1=4, fanout2=3,
        batch_size=3 * per * n, n_anom_per_batch=per * n, num_batches=2,
        num_epochs=1, valid_epochs=1, eval_batch=32, seed=0, device=dev)
    loss_dp = MiniBatchTrainer(**kwargs, mesh=mesh).train().history[-1][
        "loss"]
    loss_1 = MiniBatchTrainer(**kwargs).train().history[-1]["loss"]
    _close(loss_dp, loss_1, 2e-4, "DP MiniBatchTrainer")
    out["dp minibatch"] = loss_dp
    report("DP MiniBatchTrainer", loss_dp,
           f" (== single-device {loss_1:.4f})")
    return out
