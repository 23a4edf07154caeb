"""The GSPMD full-batch path (``parallel.full_batch``, the all-gather
layout) and ``FullBatchTrainer(mesh=D, dist_impl="gspmd")`` against
``ggad_tpu.parallel.full_batch`` and the single-device port.

Same datasets (the port's synthetic generator is a bit-identical copy),
JAX's initial weights through ``interop`` and JAX's noise (each step's
``make_rng("noise")`` key replayed):

  * ``sharded_train_step``: D 8 against D 2 (1e-4 relative,
    ``tests/test_parallel.py:588-596``) and against JAX's
    ``sharded_train_step(make_mesh(8))`` (1e-4·(1 + |JAX|));
  * ``sharded_train_step_2d`` on a (4, 2) ``('nodes', 'model')`` mesh
    against the 1-D step (1e-4 relative, ``test_parallel.py:599-614``)
    and against JAX's 2-D step;
  * ``shard_params_2d`` shards exactly the leaves JAX's shards;
  * ``FullBatchTrainer(mesh=D, dist_impl="gspmd")`` for D 2 and 8 against
    JAX's GSPMD trainer (``noise_std=0``: losses 1e-4·(1 + |JAX|), final
    AUROC 1e-5) and the port's single-device COO trainer (1e-5); its
    checkpoint and resume; the CLI's ``--dist_impl gspmd``.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.models.ggad import GGAD as JaxGGAD
from ggad_tpu.models.ggad import init_ggad_params
from ggad_tpu.parallel import full_batch as jfb
from ggad_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ggad_tpu.train.full_batch import FullBatchTrainer as JaxTrainer
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.interop import params_from_flax
from ggad_tpu_torch.parallel.full_batch import (
    shard_params_2d,
    sharded_train_step,
    sharded_train_step_2d,
)
from ggad_tpu_torch.parallel.mesh import make_mesh
from ggad_tpu_torch.train.full_batch import FullBatchTrainer

STEP_DS = dict(n_nodes=256, avg_degree=8, feat_dim=16, seed=0)
N_H = 32
TR_DS = dict(n_nodes=240, avg_degree=8, feat_dim=12, n_communities=3,
             anomaly_rate=0.1, seed=3)
TRAIN_KW = dict(num_epoch=3, log_every=1, eval_every=1, noise_mean=0.02,
                noise_std=0.0, lr=5e-3, embedding_dim=16)


def jax_mesh_2d(shape=(4, 2)):
    devs = np.asarray(jax.devices()[:8]).reshape(shape)
    return Mesh(devs, axis_names=("nodes", "model"))


def port_mesh_2d(shape=(4, 2)):
    return make_mesh(8, device="cpu", axis_names=("nodes", "model"),
                     shape=shape)


@pytest.fixture(scope="module")
def jax_step_inputs():
    """JAX's initial weights and each of 2 steps' noise in
    ``sharded_train_step`` (``full_batch.py:172-190``)."""
    ds = jax_synthetic_gad(**STEP_DS)
    model = JaxGGAD(n_h=N_H, noise_mean=0.02, noise_std=0.01)
    rng, init_rng, noise_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    params = init_ggad_params(model, ds.feat_dim,
                              {"params": init_rng, "noise": noise_rng})
    noises = []
    for _ in range(2):
        rng, step_rng = jax.random.split(rng)
        key = model.apply(params, rngs={"noise": step_rng},
                          method=lambda m: m.make_rng("noise"))
        noises.append(np.asarray(
            jax.random.normal(key, (len(ds.abnormal_label_idx), N_H))
            * 0.01 + 0.02))
    return jax.tree.map(np.asarray, params), noises


def test_sharded_train_step_matches_d2_and_jax(jax_step_inputs):
    params, noises = jax_step_inputs
    ds = synthetic_gad(**STEP_DS)
    kw = dict(n_h=N_H, n_steps=2, initial_params=params, noises=noises,
              device="cpu")
    loss8 = sharded_train_step(8, ds, **kw)
    loss2 = sharded_train_step(2, ds, **kw)
    expect = jfb.sharded_train_step(jax_make_mesh(8),
                                    jax_synthetic_gad(**STEP_DS), n_h=N_H,
                                    n_steps=2)
    assert np.isfinite(loss8)
    assert loss8 == pytest.approx(loss2, rel=1e-4)
    assert abs(loss8 - expect) <= 1e-4 * (1 + abs(expect))


def test_sharded_train_step_2d_matches_1d_and_jax(jax_step_inputs):
    params, noises = jax_step_inputs
    ds = synthetic_gad(**STEP_DS)
    kw = dict(n_h=N_H, n_steps=2, initial_params=params, noises=noises)
    loss_2d = sharded_train_step_2d(port_mesh_2d(), ds, **kw)
    loss_1d = sharded_train_step(make_mesh(8, device="cpu"), ds, **kw)
    expect = jfb.sharded_train_step_2d(jax_mesh_2d(),
                                       jax_synthetic_gad(**STEP_DS),
                                       n_h=N_H, n_steps=2)
    assert np.isfinite(loss_2d)
    assert loss_2d == pytest.approx(loss_1d, rel=1e-4)
    assert abs(loss_2d - expect) <= 1e-4 * (1 + abs(expect))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_shard_params_2d_shards_the_leaves_jax_shards(jax_step_inputs,
                                                       shape):
    params, _ = jax_step_inputs
    placed = jfb.shard_params_2d(params, jax_mesh_2d(shape))
    flags = jax.tree.map(
        lambda a: np.full(a.shape, any(s is not None
                                       for s in a.sharding.spec),
                          np.float32), placed)
    jax_sharded = {k for k, v in params_from_flax(flags).items()
                   if v.numel() and bool(v.reshape(-1)[0])}
    full = params_from_flax(params)
    mesh = port_mesh_2d(shape)
    got = shard_params_2d(full, mesh)
    m = shape[1]
    port_sharded = {k for k, v in got.items() if v.shape != full[k].shape}
    assert port_sharded == jax_sharded and port_sharded
    for k in port_sharded:
        assert tuple(got[k].shape) == (m, full[k].shape[0] // m,
                                       *full[k].shape[1:])
        torch.testing.assert_close(got[k].reshape(full[k].shape), full[k])


@pytest.fixture(scope="module")
def jax_params():
    key = jax.random.PRNGKey(3)
    params = init_ggad_params(JaxGGAD(n_h=16), TR_DS["feat_dim"],
                              {"params": key, "noise": key})
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_gspmd_run(jax_params):
    return JaxTrainer(jax_synthetic_gad(**TR_DS), mesh=8, dist_impl="gspmd",
                      initial_params=jax_params, **TRAIN_KW).train()


@pytest.fixture(scope="module")
def single_coo(jax_params):
    return FullBatchTrainer(synthetic_gad(**TR_DS), spmm_impl="coo",
                            initial_params=jax_params, device="cpu",
                            **TRAIN_KW).train()


@pytest.mark.parametrize("D", [2, 8])
def test_gspmd_trainer_matches_jax_and_single_device(jax_params,
                                                     jax_gspmd_run,
                                                     single_coo, D):
    tr = FullBatchTrainer(synthetic_gad(**TR_DS), mesh=D, dist_impl="gspmd",
                          spmm_impl="bcsr", initial_params=jax_params,
                          device="cpu", **TRAIN_KW)
    assert tr.route == "coo" and tr.spmm_impl == "coo"
    assert tr.mesh.n_shards == D
    got = tr.train()
    for ref, tol in ((jax_gspmd_run, 1e-4), (single_coo, 1e-5)):
        assert [r["epoch"] for r in got.history] == \
            [r["epoch"] for r in ref.history]
        for g, e in zip(got.history, ref.history):
            assert g.keys() == e.keys()
            for k in g:
                assert abs(g[k] - e[k]) <= tol * (1 + abs(e[k])), \
                    (g["epoch"], k)
        assert got.final_auc == pytest.approx(ref.final_auc, abs=1e-5)


def test_gspmd_trainer_resumes_from_its_checkpoint(tmp_path):
    kw = dict(embedding_dim=16, mesh=4, dist_impl="gspmd", device="cpu",
              noise_mean=0.02, noise_std=0.05, log_every=1, eval_every=1,
              lr=5e-3)
    ds = synthetic_gad(**TR_DS)
    whole = FullBatchTrainer(ds, num_epoch=4, **kw).train()
    ck = str(tmp_path / "ck")
    FullBatchTrainer(ds, num_epoch=2, checkpoint_dir=ck, **kw).train()
    res = FullBatchTrainer(ds, num_epoch=4, checkpoint_dir=ck, **kw).train()
    for got, exp in zip(res.history, whole.history[2:]):
        assert got.keys() == exp.keys()
        for k in got:
            assert got[k] == pytest.approx(exp[k], rel=1e-6, abs=1e-6), k
    assert res.final_auc == pytest.approx(whole.final_auc, abs=1e-6)


def test_cli_dist_impl_gspmd(capsys):
    argv = ["--dataset", "photo", "--synthetic_scale", "0.05",
            "--embedding_dim", "16", "--num_epoch", "3", "--eval_every",
            "2", "--device", "cpu"]
    cli_main(argv + ["--mesh_devices", "4", "--dist_impl", "gspmd"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli_main(argv + ["--spmm_impl", "coo"])
    single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["n_shards"], got["spmm_route"]) == (4, "coo")
    assert got["auc"] == pytest.approx(single["auc"], abs=1e-5)
    assert got["ap"] == pytest.approx(single["ap"], abs=1e-5)


@pytest.mark.parametrize("mesh", [
    lambda: make_mesh(2, device="cpu"), lambda: make_mesh(8, device="cpu"),
    lambda: port_mesh_2d((4, 2))], ids=["D2", "D8", "nodes4xmodel2"])
def test_shard_graph_and_node_array_aggregate_as_one_device(mesh):
    """``shard_graph`` and ``shard_node_array`` (on a 2-D mesh, over its
    ``'nodes'`` axis) give the blocks whose all-gather aggregation is the
    single-device ``Â·x``; ``replicate`` puts a tree on the device."""
    from ggad_tpu_torch.graph import from_scipy
    from ggad_tpu_torch.ops.normalize import normalize_adj_reference
    from ggad_tpu_torch.ops.spmm import spmm
    from ggad_tpu_torch.parallel.full_batch import (
        replicate,
        shard_graph,
        shard_node_array,
    )
    from ggad_tpu_torch.parallel.spmm_shard import spmm_sharded

    mesh = mesh()
    ds = synthetic_gad(**STEP_DS)
    adj, _ = normalize_adj_reference(from_scipy(ds.adj, device="cpu"))
    x = torch.from_numpy(np.asarray(ds.features, np.float32))
    nodes = mesh.axis("nodes") if hasattr(mesh, "axis") else mesh
    part = shard_graph(adj, mesh)
    xs = shard_node_array(x, mesh)
    assert xs.shape[:2] == (nodes.n_shards, part.rows_per_shard)
    got = nodes.all_gather(spmm_sharded(part, xs, nodes))[:ds.n_nodes]
    torch.testing.assert_close(got, spmm(adj, x, impl="coo"), rtol=1e-5,
                               atol=1e-5)
    tree = replicate({"a": np.ones(3), "b": {"c": torch.zeros(2)}}, mesh)
    assert tree["b"]["c"].device == mesh.device
