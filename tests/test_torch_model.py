"""Weights and the GGAD eval forward against ``ggad_tpu``: a flax init tree
round-trips exactly, and eval logits from the carried-over weights match
``GGAD.apply(..., train=False)`` to 1e-5 rel/abs (f32 everywhere; the sums
run in another order) on the gather path and on the BCSR path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggad_tpu.graph as jg
import ggad_tpu.ops.normalize as jn
import ggad_tpu.ops.pallas_spmm as jp
from ggad_tpu.datasets.synthetic import synthetic_gad
from ggad_tpu.models.ggad import GGAD as JaxGGAD
from ggad_tpu.ops.spmm import spmm as jax_spmm
import ggad_tpu_torch.graph as pg
import ggad_tpu_torch.ops.normalize as pn
from ggad_tpu_torch.interop import params_from_flax, params_to_flax
from ggad_tpu_torch.models.ggad import GGAD
from ggad_tpu_torch.ops.bcsr_spmm import as_bcsr_graph
from ggad_tpu_torch.ops.spmm import spmm

N_H = 32


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_gad(n_nodes=260, avg_degree=8, feat_dim=20,
                       n_communities=3, anomaly_rate=0.1, seed=4)
    j_adj, _ = jn.normalize_adj_reference(jg.from_scipy(ds.adj))
    x = jnp.asarray(ds.features)
    seed_idx = jnp.asarray(ds.abnormal_label_idx, jnp.int32)
    normal_idx = jnp.asarray(ds.normal_label_idx, jnp.int32)
    model = JaxGGAD(n_h=N_H, noise_mean=0.02, noise_std=0.01)
    params = model.init({"params": jax.random.PRNGKey(0),
                         "noise": jax.random.PRNGKey(1)},
                        j_adj, x, seed_idx, normal_idx, train=True)
    return ds, j_adj, x, seed_idx, normal_idx, model, params


def test_params_round_trip_exactly(setup):
    *_, params = setup
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert state["gcn1.fc.weight"].shape == (N_H, 20)     # [out, in]
    assert state["head.fc3.weight"].shape == (1, N_H // 4)
    assert state["gcn2.prelu.alpha"].shape == ()
    back = params_to_flax(state)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) == 10
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_state_dict_keys_match_the_port_model(setup):
    *_, params = setup
    state = params_from_flax(jax.tree.map(np.asarray, params))
    model = GGAD(20, N_H)
    assert set(model.state_dict()) == set(state)
    for k, v in model.state_dict().items():
        assert v.shape == state[k].shape, k
    model.load_state_dict(state)


@pytest.mark.parametrize("route", ["coo", "bcsr-f32", "bcsr-tall"])
def test_eval_logits_match_jax(setup, route):
    ds, j_adj, x, seed_idx, normal_idx, jmodel, params = setup
    j_ax = jax_spmm(j_adj, x, impl="xla")
    if route == "coo":
        j_graph = j_adj
    else:
        j_graph = jp.as_bcsr_graph(
            j_adj, tile_rows=128 if route == "bcsr-f32" else 256)
    j_out = jmodel.apply(params, j_graph, x, seed_idx, normal_idx,
                         train=False, ax=j_ax,
                         rngs={"noise": jax.random.PRNGKey(2)})

    p_adj, _ = pn.normalize_adj_reference(pg.from_scipy(ds.adj, device="cpu"))
    xt = torch.from_numpy(ds.features)
    p_ax = spmm(p_adj, xt, impl="coo")
    p_graph = p_adj if route == "coo" else as_bcsr_graph(
        p_adj, tile_rows=128 if route == "bcsr-f32" else 256)
    model = GGAD(ds.feat_dim, N_H)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = model(p_graph, xt, ax=p_ax)
        out_no_hoist = model(p_graph, xt)
    np.testing.assert_allclose(p_ax.numpy(), np.asarray(j_ax),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.emb.numpy(), np.asarray(j_out.emb),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(j_out.logits),
                               rtol=1e-5, atol=1e-5)
    # hoisting Â·x changes the op order, not the math
    np.testing.assert_allclose(out_no_hoist.logits.numpy(),
                               out.logits.numpy(), rtol=1e-4, atol=1e-5)


def test_train_branch_is_not_ported_yet(setup):
    ds = setup[0]
    g = pg.from_scipy(ds.adj, device="cpu")
    with pytest.raises(NotImplementedError):
        GGAD(ds.feat_dim, N_H)(g, torch.from_numpy(ds.features), train=True)


def test_seeded_init_distribution():
    """The port's own init: Xavier-uniform bounds, PReLU 0.25, zero bias,
    and the same weights from the same seed."""
    a = GGAD(745, 300, generator=torch.Generator().manual_seed(0))
    b = GGAD(745, 300, generator=torch.Generator().manual_seed(0))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    w = a.gcn1.fc.weight
    bound = np.sqrt(6.0 / (745 + 300))
    assert w.abs().max().item() <= bound
    assert w.std().item() == pytest.approx(bound / np.sqrt(3), rel=0.02)
    assert a.gcn1.prelu.alpha.item() == 0.25
    assert a.gcn2.bias.abs().sum().item() == 0.0
