"""Data-parallel minibatch GGAD (``parallel.minibatch_dp`` and
``MiniBatchTrainer(mesh=D)``) against ``ggad_tpu`` and the single-device
port.

  * ``MiniBatchTrainer(mesh=D)`` for D 2, 4 and 8 against JAX's
    ``MiniBatchTrainer(mesh=8)`` on the graph and settings of
    ``tests/test_parallel.py:563-585``, from JAX's initial weights and its
    replayed draws (``test_torch_minibatch_train.JaxDraws``, in the run's
    order): each epoch's
    losses within 2e-4 relative, the test AUROC within 1e-3 (JAX's own
    bounds for its DP trainer against its single-device one);
  * the same trainers against the port's single-device trainer: losses
    and validation AUROC within 1e-5·(1 + |ref|), one step's gradients
    within 1e-5;
  * a D that does not divide the batch raises JAX's ``ValueError``;
  * ``run_dp_minibatch_demo``: D 8 equals D 1 within 1e-5 relative and
    JAX's D 8 demo within 1e-4 relative, from JAX's init and draws
    (``tests/test_parallel.py:628-640``);
  * the slot-mask decomposition of the losses at B 150 + 50 over 4 shards,
    where the last shard holds anomaly slots only: losses and gradients
    equal to the single-device ones (1e-6 / 1e-5).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_torch_minibatch_train import JaxDraws

from ggad_tpu.datasets.splits import minibatch_split as jax_minibatch_split
from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.models.sage import MiniBatchGGAD as JaxMiniBatchGGAD
from ggad_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ggad_tpu.parallel.minibatch_dp import (
    run_dp_minibatch_demo as jax_dp_demo,
)
from ggad_tpu.sampler.neighbor import NeighborTable as JaxTable
from ggad_tpu.train.minibatch import MiniBatchTrainer as JaxTrainer
from ggad_tpu_torch.datasets.splits import minibatch_split
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.models.sage import MiniBatchGGAD, minibatch_ggad_losses
from ggad_tpu_torch.parallel.mesh import make_mesh
from ggad_tpu_torch.parallel.minibatch_dp import (
    dp_minibatch_losses,
    run_dp_minibatch_demo,
)
from ggad_tpu_torch.sampler.neighbor import NeighborTable
from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

TR_KW = dict(emb_dim=16, fanout1=4, fanout2=3, batch_size=24,
             n_anom_per_batch=8, num_batches=4, num_epochs=2,
             valid_epochs=1, eval_batch=32, seed=0)
LOSS_KEYS = ("loss", "loss_cls", "loss_constraint", "loss_rec")


def inputs(pkg_synthetic, split):
    ds = pkg_synthetic(n_nodes=800, avg_degree=8, feat_dim=12, seed=2)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = split(
        ds.ano_labels, seed=0, pseudo_anomaly_frac=0.1)
    return dict(adj=adj, features=ds.features, labels=labels,
                idx_train=idx_train, idx_anomaly=idx_anom,
                idx_valid=idx_valid, idx_test=idx_test)


class EpochDraws(JaxDraws):
    """JAX's draws in the order this run asks for them: an epoch's two
    training draws, then a validation scoring (every epoch here), then the
    test scoring. (B = eval_batch = 32, so the shapes alone cannot tell a
    training draw from a scoring one.)"""

    def __init__(self, jt, params):
        super().__init__(jt, params)
        self.next = "u1"

    def __call__(self, shape):
        if self.next == "eval":
            self.next = "u1" if self.train else "eval"
            keys = jax.random.split(jax.random.PRNGKey(1234), shape[0])
            return np.stack([jax.random.uniform(self.sample_key(k),
                                                shape[1:]) for k in keys])
        self.next = "u2" if self.next == "u1" else "eval"
        u = self.train.pop(0)
        assert u.shape == shape
        return u


def port_trainer(**kw):
    return MiniBatchTrainer(**inputs(synthetic_gad, minibatch_split),
                            **TR_KW, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_run():
    jt = JaxTrainer(**inputs(jax_synthetic_gad, jax_minibatch_split),
                    **TR_KW, mesh=8)
    params, _ = jt.init(jax.random.split(jax.random.PRNGKey(jt.seed))[1])
    params = jax.tree.map(np.asarray, params)
    return jt, params, jt.train()


@pytest.fixture(scope="module")
def single():
    return port_trainer().train()


@pytest.mark.parametrize("D", [2, 4, 8])
def test_dp_trainer_matches_jax_dp(jax_run, D):
    jt, params, jres = jax_run
    res = port_trainer(mesh=D, initial_params=params,
                       draws=EpochDraws(jt, params)).train()
    assert len(res.history) == len(jres.history) == TR_KW["num_epochs"]
    for a, b in zip(res.history, jres.history):
        for k in LOSS_KEYS:
            assert a[k] == pytest.approx(b[k], rel=2e-4), k
    assert res.test_metrics["auc"] == pytest.approx(
        jres.test_metrics["auc"], abs=1e-3)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_dp_trainer_matches_single_device(single, D):
    tr = port_trainer(mesh=D)
    assert tr.mesh.n_shards == D and tr.feats.data_ptr() > 0
    res = tr.train()
    for a, b in zip(res.history, single.history):
        for k in (*LOSS_KEYS, "val_auc"):
            assert abs(a[k] - b[k]) <= 1e-5 * (1 + abs(b[k])), k
    assert res.best_epoch == single.best_epoch


@pytest.mark.parametrize("D", [2, 4, 8])
def test_dp_step_gradients_match_single_device(D):
    grads = []
    for mesh in (None, D):
        tr = port_trainer(mesh=mesh)
        batches = tr.draw_batches(np.random.default_rng(5))
        gen = torch.Generator().manual_seed(5)
        b = batches.shape[1]
        u1 = torch.rand(b, TR_KW["fanout1"], generator=gen)
        u2 = torch.rand(b * TR_KW["fanout1"], TR_KW["fanout2"],
                        generator=gen)
        tr.compute_losses(batches[0], u1, u2).total.backward()
        grads.append({k: p.grad for k, p in tr.model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-5, atol=1e-5,
                                   msg=k)


def test_dp_mesh_must_divide_the_batch():
    with pytest.raises(ValueError) as port:
        port_trainer(mesh=3)
    with pytest.raises(ValueError) as jax_err:
        JaxTrainer(**inputs(jax_synthetic_gad, jax_minibatch_split),
                   **TR_KW, mesh=3)
    assert str(port.value) == str(jax_err.value) == (
        "batch sizes (32, eval 32) must divide the mesh size 3")


def test_dp_demo_matches_d1_and_jax():
    ds = synthetic_gad(n_nodes=300, avg_degree=8, feat_dim=12, seed=1)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    batch = np.random.default_rng(0).integers(0, ds.n_nodes, 32 + 16)
    jds = jax_synthetic_gad(n_nodes=300, avg_degree=8, feat_dim=12, seed=1)
    jadj = jds.adj + sp.eye(jds.n_nodes, format="csr", dtype=np.float32)
    j8 = jax_dp_demo(jax_make_mesh(8), jadj, jds.features, batch, n_anom=16)

    # JAX's init and draws (minibatch_dp.py:65-70, sample_two_hop)
    model = JaxMiniBatchGGAD(emb_dim=16, fanout1=4, fanout2=3)
    feats = jax.numpy.asarray(jds.features, jax.numpy.float32)
    jbatch = jax.numpy.asarray(batch, jax.numpy.int32)
    rng, ik, sk = jax.random.split(jax.random.PRNGKey(0), 3)
    params = model.init({"params": ik, "sample": sk}, feats,
                        JaxTable.from_scipy(jadj), jbatch, 16, True)
    key = model.apply(params, rngs={"sample": rng},
                      method=lambda m: m.make_rng("sample"))
    r1, r2 = jax.random.split(key)
    u1 = np.asarray(jax.random.uniform(r1, (48, 4)))
    u2 = np.asarray(jax.random.uniform(r2, (48 * 4, 3)))
    params = jax.tree.map(np.asarray, params)
    kw = dict(n_anom=16, initial_params=params, u1=u1, u2=u2, device="cpu")
    p8 = run_dp_minibatch_demo(8, adj, ds.features, batch, **kw)
    p1 = run_dp_minibatch_demo(1, adj, ds.features, batch, **kw)
    assert np.isfinite(p8)
    assert p8 == pytest.approx(p1, rel=1e-5)
    assert p8 == pytest.approx(j8, rel=1e-4)
    # seeded draws and weights without the caller's
    assert np.isfinite(run_dp_minibatch_demo(4, adj, ds.features, batch,
                                             n_anom=16, device="cpu"))


def test_slot_mask_decomposition_anomaly_only_shard():
    """B 200 = 150 + 50 over 4 shards of 50: shard 3 holds only anomaly
    slots, shard 2 only normal ones. The psum'd masked sums, divided by
    the global counts, give the single-device means term for term."""
    ds = synthetic_gad(n_nodes=400, avg_degree=8, feat_dim=12, seed=4)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    table = NeighborTable.from_scipy(adj, device="cpu")
    feats = torch.from_numpy(np.asarray(ds.features, np.float32))
    gen = torch.Generator().manual_seed(0)
    batch = torch.randint(0, ds.n_nodes, (200,), generator=gen,
                          dtype=torch.int32)
    u1 = torch.rand(200, 4, generator=gen)
    u2 = torch.rand(800, 3, generator=gen)
    model = MiniBatchGGAD(12, 16, 4, 3, generator=gen)
    out = model(feats, table, batch, 50, True, u1=u1, u2=u2)
    ref = minibatch_ggad_losses(out, 50)
    ref.total.backward()
    ref_g = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    mesh = make_mesh(4, device="cpu")
    got = dp_minibatch_losses(model, feats, table, batch, u1, u2, 50, mesh)
    got.total.backward()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-6)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, ref_g[k], rtol=1e-5, atol=1e-5)
