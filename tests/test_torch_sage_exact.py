"""The exact set-union replay against ``ggad_tpu.models.sage_exact``.

The same CSR (the symmetrized graph without self-loops, as
``scripts/reference_oracle.py:902-909`` builds it), the same batches and
JAX's initial weights. Each training batch carries a contaminated label-1
node in the middle, so the reordering quirk (scores and context in
different orders) is exercised. Tolerances: the batch arrays and pads
exact; forward outputs, losses, gradients, eval scores and a 5-step
trajectory under torch ``Adam(weight_decay)`` against JAX's
``coupled_adam`` 1e-5 (XLA's CPU ``rsqrt`` can be 1 ulp off a correctly
rounded one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from ggad_tpu.models import sage_exact as jx
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.models import sage_exact as px

F, EMB, N, TOL = 12, 16, 300, 1e-5
FIELDS = ("nodes", "labels", "uniq", "expand", "mask1", "mask2", "perm")


@pytest.fixture(scope="module")
def graph():
    ds = synthetic_gad(n_nodes=N, avg_degree=6, feat_dim=F, seed=4)
    indptr, indices = px.replay_adjacency(ds.adj)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(5):
        nodes = rng.choice(N, 20, replace=False)
        labels = np.r_[np.zeros(14), np.ones(6)].astype(np.float32)
        labels[5] = 1.0                       # a contaminated node mid-batch
        batches.append((nodes, labels))
    return dict(feats=ds.features, adj=ds.adj, indptr=indptr,
                indices=indices, batches=batches)


def oracle_pads(indptr, indices, batches, multiple):
    """``scripts/reference_oracle.py:918-932``'s pads."""
    u_max = e_max = 0
    for nodes in batches:
        sets = [set(indices[indptr[n]: indptr[n + 1]].tolist()) | {int(n)}
                for n in nodes]
        uniq = set().union(*sets)
        exp = set().union(*[set(indices[indptr[n]: indptr[n + 1]].tolist())
                            for n in uniq])
        u_max, e_max = max(u_max, len(uniq)), max(e_max, len(exp))
    return -(-u_max // multiple) * multiple, -(-e_max // multiple) * multiple


def both_batches(graph, i, pads, two_hop=True):
    nodes, labels = graph["batches"][i]
    args = (graph["indptr"], graph["indices"], nodes, labels, *pads)
    return (px.build_exact_batch(*args, two_hop=two_hop, device="cpu"),
            jx.build_exact_batch(*args, two_hop=two_hop))


def jax_params(seed=7):
    return jx.init_exact_params(jax.random.PRNGKey(seed), F, EMB)


def port_params(jp):
    return {k: torch.tensor(np.asarray(v), requires_grad=True)
            for k, v in jp.items()}


def test_replay_adjacency_and_pads(graph):
    a = sp.csr_matrix(graph["adj"])
    want = ((a + a.T) > 0).astype(np.float32).tocsr()
    np.testing.assert_array_equal(graph["indptr"], want.indptr)
    np.testing.assert_array_equal(graph["indices"], want.indices)
    assert want.diagonal().sum() == 0             # no self-loop added
    nodes = [b[0] for b in graph["batches"]]
    assert px.exact_pads(graph["indptr"], graph["indices"], nodes) \
        == oracle_pads(graph["indptr"], graph["indices"], nodes, 64)


@pytest.mark.parametrize("two_hop", [True, False])
def test_build_exact_batch_equals_jax(graph, two_hop):
    pads = px.exact_pads(graph["indptr"], graph["indices"],
                         [b[0] for b in graph["batches"]])
    got, want = both_batches(graph, 0, pads, two_hop)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    moved = got.to("cpu")
    assert all(torch.equal(getattr(moved, f), getattr(got, f))
               for f in FIELDS)


def test_forward_losses_and_grads_match_jax(graph):
    pads = px.exact_pads(graph["indptr"], graph["indices"],
                         [b[0] for b in graph["batches"]])
    pb, jb = both_batches(graph, 0, pads)
    jp = jax_params()
    feats = jnp.asarray(graph["feats"])
    jfwd = jx.exact_forward(jp, feats, jb)
    (jtotal, jparts), jgrads = jax.value_and_grad(
        jx.exact_losses, has_aux=True)(jp, feats, jb)
    pp = port_params(jp)
    x = torch.as_tensor(graph["feats"])
    for got, want in zip(px.exact_forward(pp, x, pb), jfwd):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    total, parts = px.exact_losses(pp, x, pb)
    for got, want in zip((total, *parts), (jtotal, *jparts)):
        assert float(got) == pytest.approx(float(want), rel=TOL, abs=TOL)
    total.backward()
    for k, p in pp.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    # the quirk shows: the contaminated node's score row is a normal's
    assert not torch.equal(pb.perm, torch.arange(20))


def test_five_step_trajectory_matches_coupled_adam(graph):
    nodes = [b[0] for b in graph["batches"]]
    pads = px.exact_pads(graph["indptr"], graph["indices"], nodes)
    feats = jnp.asarray(graph["feats"])
    jp = jax_params(8)
    pp = port_params(jp)
    tx = jx.coupled_adam(1e-3, 0.007)
    opt_state = tx.init(jp)
    opt = torch.optim.Adam(pp.values(), lr=1e-3, weight_decay=0.007)
    x = torch.as_tensor(graph["feats"])
    for i in range(5):
        pb, jb = both_batches(graph, i, pads)
        (jloss, _), grads = jax.value_and_grad(
            jx.exact_losses, has_aux=True)(jp, feats, jb)
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        loss, _ = px.exact_losses(pp, x, pb)
        loss.backward()
        opt.step()
        assert float(loss) == pytest.approx(float(jloss), rel=TOL, abs=TOL)
    for k, p in pp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_exact_score_nodes_matches_jax_slices(graph):
    """Eval in 150-node slices, the 1-hop pad rounded to 32
    (``scripts/reference_oracle.py:945-977``)."""
    jp = jax_params(9)
    ids = np.random.default_rng(1).permutation(N)[:230]
    indptr, indices = graph["indptr"], graph["indices"]
    slices = [ids[i * 150: min((i + 1) * 150, len(ids))]
              for i in range(len(ids) // 150 + 1)]
    u_ev = -(-max(len(set().union(*[
        set(indices[indptr[n]: indptr[n + 1]].tolist()) | {int(n)}
        for n in s])) for s in slices) // 32) * 32
    want = np.concatenate([np.asarray(jx.exact_scores(
        jp, jnp.asarray(graph["feats"]), jx.build_exact_batch(
            indptr, indices, s, np.zeros(len(s), np.float32), u_ev, 32,
            two_hop=False))) for s in slices])
    got = px.exact_score_nodes(port_params(jp),
                               torch.as_tensor(graph["feats"]), indptr,
                               indices, ids)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_init_exact_params_shapes_and_bounds():
    p = px.init_exact_params(F, EMB, generator=torch.Generator().manual_seed(
        0), device="cpu")
    want = jax_params()
    for k, v in p.items():
        assert v.shape == want[k].shape and v.requires_grad
        bound = float(np.sqrt(6.0 / sum(v.shape)))
        assert float(v.abs().max()) <= bound
