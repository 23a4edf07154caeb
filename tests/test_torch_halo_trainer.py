"""The halo GGAD step and ``FullBatchTrainer(mesh=D)`` against
``ggad_tpu.parallel.halo_trainer`` and the single-device port.

Same dataset (the port's synthetic generator is a bit-identical copy),
JAX's initial weights through ``interop`` and a fixed noise on both
sides:

  * ``halo_ggad_forward_and_losses`` term by term against JAX's (its
    production path: hoisted Â·x, seed rows, margin subset) and against
    the single-device port, rtol 1e-4 / atol 1e-5
    (``tests/test_parallel.py:446-450``), on the port's BCSR, ELL and COO
    routes, with the parameters' gradients against the single-device
    port's (1e-4);
  * ``FullBatchTrainer(mesh=D)``, 3 steps and an evaluation every epoch,
    against JAX's halo trainer (``noise_std=0``, so both perturb by the
    mean): losses, AUROC and AP to 1e-4, for D 2 and 4, the dense, ring
    and sched wires, the BCSR and ELL routes (JAX's CPU halo is
    edge-parallel: the same math);
  * bf16: the halo against the single-device bf16 trainer (1e-3: both
    round the tiles and operands to bf16; the halo also rounds the
    hoisted Â·x, which the single-device path computes in f32);
  * the CLI's ``--mesh_devices 4 --device cpu`` against its single-device
    run; ``dist_impl="gspmd"`` building the GSPMD trainer, and the
    ``dist_impl`` / ``--dist_schedule`` checks raising.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.models.ggad import GGAD, init_ggad_params
from ggad_tpu.parallel.halo_trainer import (
    halo_ggad_forward_and_losses as jax_halo_losses,
)
from ggad_tpu.parallel.halo_trainer import prepare_halo as jax_prepare_halo
from ggad_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ggad_tpu.train.full_batch import FullBatchTrainer as JaxTrainer
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.interop import params_from_flax
from ggad_tpu_torch.parallel.halo_trainer import prepare_halo
from ggad_tpu_torch.parallel.mesh import make_mesh
from ggad_tpu_torch.train.full_batch import FullBatchTrainer

N_H = 16
DS_KW = dict(n_nodes=240, avg_degree=8, feat_dim=12, n_communities=3,
             anomaly_rate=0.1, seed=3)
LOSS_FIELDS = ("total", "bce", "margin", "rec", "affinity_normal",
               "affinity_outlier")
TRAIN_KW = dict(num_epoch=3, log_every=1, eval_every=1, noise_mean=0.02,
                noise_std=0.0, lr=5e-3)


@pytest.fixture(scope="module")
def jax_params():
    key = jax.random.PRNGKey(3)
    params = init_ggad_params(GGAD(n_h=N_H), DS_KW["feat_dim"],
                              {"params": key, "noise": key})
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def noise():
    ds = synthetic_gad(**DS_KW)
    return np.random.default_rng(1).normal(
        0.02, 0.01, (len(ds.abnormal_label_idx), N_H)).astype(np.float32)


def single_device(route, jax_params, noise, dtype="float32"):
    """The single-device port's losses and gradients at JAX's weights."""
    tr = FullBatchTrainer(synthetic_gad(**DS_KW), embedding_dim=N_H,
                          spmm_impl=route, spmm_dtype=dtype,
                          initial_params=jax_params, device="cpu")
    tr.model.load_state_dict(tr.initial_state())
    losses = tr.compute_losses(torch.from_numpy(noise))
    losses.total.backward()
    return losses, {k: p.grad for k, p in tr.model.named_parameters()}


@pytest.fixture(scope="module")
def jax_losses(jax_params, noise):
    """JAX's halo losses (jitted; eager shard_map costs seconds an op),
    once per (D, schedule)."""
    cache = {}

    def run(D, schedule):
        if (D, schedule) not in cache:
            jmesh = jax_make_mesh(D)
            js = jax_prepare_halo(jax_synthetic_gad(**DS_KW), jmesh,
                                  schedule=schedule)
            cache[D, schedule] = jax.jit(lambda p, n: jax_halo_losses(
                p, js.part, js.plan, js.x_pad, js.seed_idx, js.normal_idx,
                n, js.raw_part, js.raw_plan, jmesh, ax=js.ax,
                seed_rows=js.seed_rows, aff_sub=js.aff_sub))(
                    jax_params, jnp.asarray(noise))
        return cache[D, schedule]

    return run


@pytest.mark.parametrize("route", ["bcsr", "ell", "coo"])
@pytest.mark.parametrize("D,schedule", [(2, "dense"), (4, "sched")])
def test_halo_losses_match_jax_and_single_device(jax_params, noise,
                                                 jax_losses, route, D,
                                                 schedule):
    expect = jax_losses(D, schedule)

    mesh = make_mesh(D, device="cpu")
    setup = prepare_halo(synthetic_gad(**DS_KW), mesh, spmm_impl=route,
                         schedule=schedule)
    assert setup.route == route
    assert (setup.tiles is not None) == (route == "bcsr")
    assert (setup.ells is not None) == (route == "ell")
    assert (setup.aff_sub.t_fwd is not None) == (route == "bcsr")
    params = {k: v.requires_grad_(True)
              for k, v in params_from_flax(jax_params).items()}
    got = setup.losses(params, torch.from_numpy(noise), mesh)
    got.total.backward()
    ref, ref_grads = single_device(route, jax_params, noise)
    for name in LOSS_FIELDS:
        g = getattr(got, name).item()
        np.testing.assert_allclose(g, float(getattr(expect, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g, getattr(ref, name).item(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert params.keys() == ref_grads.keys()
    for k, p in params.items():
        torch.testing.assert_close(p.grad, ref_grads[k], rtol=1e-4,
                                   atol=1e-4, msg=k)


@pytest.fixture(scope="module")
def jax_runs(jax_params):
    """JAX's halo trainer, 3 epochs, once per (D, schedule)."""
    cache = {}

    def run(D, schedule):
        if (D, schedule) not in cache:
            cache[D, schedule] = JaxTrainer(
                jax_synthetic_gad(**DS_KW), embedding_dim=N_H,
                spmm_impl="xla", mesh=D, dist_impl="halo",
                dist_schedule=schedule, initial_params=jax_params,
                **TRAIN_KW).train()
        return cache[D, schedule]

    return run


@pytest.mark.parametrize("route", ["bcsr", "ell"])
@pytest.mark.parametrize("D,schedule", [(2, "dense"), (2, "ring"),
                                        (2, "sched"), (4, "dense"),
                                        (4, "ring"), (4, "sched")])
def test_mesh_trainer_matches_jax_halo_trainer(jax_params, jax_runs, route,
                                               D, schedule):
    expect = jax_runs(D, schedule)
    tr = FullBatchTrainer(synthetic_gad(**DS_KW), embedding_dim=N_H,
                          spmm_impl=route, mesh=D, dist_schedule=schedule,
                          initial_params=jax_params, device="cpu",
                          **TRAIN_KW)
    assert tr.route == route and tr.mesh.n_shards == D
    got = tr.train()
    assert [r["epoch"] for r in got.history] == \
        [r["epoch"] for r in expect.history]
    for g, e in zip(got.history, expect.history):
        assert g.keys() == e.keys()
        for k in g:
            assert g[k] == pytest.approx(e[k], rel=1e-4, abs=1e-4), \
                (g["epoch"], k)
    assert got.final_auc == pytest.approx(expect.final_auc, abs=1e-4)
    assert got.final_ap == pytest.approx(expect.final_ap, abs=1e-4)


def test_bf16_halo_matches_single_device_bf16(jax_params):
    kw = dict(embedding_dim=N_H, spmm_impl="bcsr", spmm_dtype="bfloat16",
              initial_params=jax_params, device="cpu", **TRAIN_KW)
    ds = synthetic_gad(**DS_KW)
    got = FullBatchTrainer(ds, mesh=4, **kw).train()
    expect = FullBatchTrainer(ds, **kw).train()
    for g, e in zip(got.history, expect.history):
        for k in g:
            assert g[k] == pytest.approx(e[k], rel=1e-3, abs=1e-3), k


def test_mesh_trainer_resumes_from_its_checkpoint(tmp_path):
    """``train()``'s checkpoints are the single-device path's: 2 epochs,
    then a new trainer resumes to 4, equal to 4 in one go (noise
    generator state included)."""
    kw = dict(embedding_dim=N_H, spmm_impl="bcsr", mesh=4, device="cpu",
              noise_mean=0.02, noise_std=0.05, log_every=1, eval_every=1,
              lr=5e-3)
    ds = synthetic_gad(**DS_KW)
    whole = FullBatchTrainer(ds, num_epoch=4, **kw).train()
    ck = str(tmp_path / "ck")
    FullBatchTrainer(ds, num_epoch=2, checkpoint_dir=ck, **kw).train()
    res = FullBatchTrainer(ds, num_epoch=4, checkpoint_dir=ck, **kw).train()
    for got, exp in zip(res.history, whole.history[2:]):
        for k in got:
            assert got[k] == pytest.approx(exp[k], rel=1e-5, abs=1e-6), k
    for k, v in whole.params.items():
        torch.testing.assert_close(res.params[k], v, rtol=1e-5, atol=1e-6)


def test_halo_training_run_agrees_across_wires_and_shard_counts():
    """JAX's invariant (``__graft_entry__.py:60-63``): the wires and the
    shard counts give the same losses, here 2 steps of
    ``FullBatchTrainer(mesh=D)`` from its seeded init and noise."""
    ds = synthetic_gad(**DS_KW)

    def total(D, schedule):
        tr = FullBatchTrainer(ds, embedding_dim=N_H, mesh=D,
                              dist_schedule=schedule, device="cpu")
        tr.model.load_state_dict(tr.init())
        gen = torch.Generator().manual_seed(0)
        return [float(tr.train_step(gen).total) for _ in range(2)][-1]

    totals = [total(D, s) for D, s in [(2, "dense"), (4, "dense"),
                                        (4, "ring"), (4, "sched"),
                                        (1, "dense")]]
    assert max(totals) - min(totals) <= 1e-5 * max(1.0, abs(totals[0]))


def test_halo_past_the_tile_budget_takes_ell(monkeypatch, jax_params,
                                             noise):
    """A tile store past the per-shard budget sends ``spmm_impl="bcsr"``
    to the ELL route (printed, as JAX does), with the BCSR route's
    losses."""
    from ggad_tpu_torch.parallel import halo_trainer

    mesh = make_mesh(2, device="cpu")
    params = params_from_flax(jax_params)
    n = torch.from_numpy(noise)
    ds = synthetic_gad(**DS_KW)
    tiled = prepare_halo(ds, mesh, spmm_impl="bcsr")
    monkeypatch.setattr(halo_trainer, "BCSR_BUDGET_BYTES", 1)
    over = prepare_halo(ds, mesh, spmm_impl="bcsr")
    assert (tiled.route, over.route) == ("bcsr", "ell")
    assert over.tiles is None and over.ells is not None
    assert over.aff_sub.t_fwd is None
    got, ref = over.losses(params, n, mesh), tiled.losses(params, n, mesh)
    for name in LOSS_FIELDS:
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6, msg=name)


def test_cli_mesh_devices_matches_single_device(capsys):
    argv = ["--dataset", "photo", "--synthetic_scale", "0.05",
            "--embedding_dim", "16", "--num_epoch", "3", "--eval_every",
            "2", "--device", "cpu", "--spmm_impl", "bcsr"]
    cli_main(argv + ["--mesh_devices", "4", "--dist_schedule", "ring"])
    halo = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli_main(argv)
    single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (halo["n_shards"], halo["spmm_route"]) == (4, "bcsr")
    assert halo["auc"] == pytest.approx(single["auc"], abs=1e-4)
    assert halo["ap"] == pytest.approx(single["ap"], abs=1e-4)


def test_dist_impl_gspmd_builds_a_gspmd_trainer():
    from ggad_tpu_torch.parallel.full_batch import GSPMDSetup

    ds = synthetic_gad(**DS_KW)
    tr = FullBatchTrainer(ds, mesh=2, dist_impl="gspmd", device="cpu")
    assert isinstance(tr._sharded, GSPMDSetup) and tr.route == "coo"
    with pytest.raises(ValueError):
        FullBatchTrainer(ds, mesh=2, dist_impl="ring", device="cpu")
    with pytest.raises(SystemExit):
        cli_main(["--mesh_devices", "2", "--dist_impl", "gspmd",
                  "--dist_schedule", "ring", "--device", "cpu"])
