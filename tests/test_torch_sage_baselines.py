"""The minibatch baselines' models against ``ggad_tpu``: GraphSAGE's
classifier, PC-GNN (one table shared by three relations, and three
relations of their own), ``pcgnn_loss`` / ``pcgnn_prob``, both
``MiniBatchRecon`` variants, ``MiniBatchAEGIS`` and ``aegis_mb_losses``;
and the relations of the synthetic generator.

Each model starts from JAX's flax init (through ``interop``) and samples
with JAX's own draws: the key that ``model.apply(params, rngs={"sample":
k}, method=lambda m: m.make_rng("sample"))`` returns, split as each JAX
module splits it. Tolerances: forward outputs, losses and gradients 1e-5;
the relation matrices exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ggad_tpu.datasets import synthetic as jax_synthetic
from ggad_tpu.models import pcgnn as jax_pcgnn
from ggad_tpu.models import sage as jax_sage
from ggad_tpu.models import sage_recon as jax_recon
from ggad_tpu.sampler.neighbor import NeighborTable as JaxTable
from ggad_tpu_torch.datasets import synthetic as pt_synthetic
from ggad_tpu_torch.interop import params_from_flax
from ggad_tpu_torch.models.pcgnn import PCGNN, pcgnn_loss, pcgnn_prob
from ggad_tpu_torch.models.sage import GraphSAGEClassifier
from ggad_tpu_torch.models.sage_recon import (
    MiniBatchAEGIS,
    MiniBatchRecon,
    aegis_mb_losses,
)
from ggad_tpu_torch.sampler.neighbor import NeighborTable

F, EMB, B, N_ANOM, N = 12, 16, 24, 8, 400
TOL = 1e-5
DS_KW = dict(n_nodes=N, avg_degree=8, feat_dim=F, anomaly_rate=0.08,
             seed=5)


@pytest.fixture(scope="module")
def data():
    ds = pt_synthetic.synthetic_gad(n_relations=3, **DS_KW)
    eye = sp.eye(N, format="csr", dtype=np.float32)
    adj = (ds.adj + eye).tocsr()
    rels = [(r + eye).tocsr() for r in ds.relations]
    rng = np.random.default_rng(0)
    normals = np.flatnonzero(ds.ano_labels == 0)
    anoms = np.flatnonzero(ds.ano_labels == 1)
    batch = np.concatenate([rng.choice(normals, B),
                            rng.choice(anoms, N_ANOM)]).astype(np.int32)
    labels = np.r_[np.zeros(B), np.ones(N_ANOM)].astype(np.int32)
    return dict(feats=ds.features, adj=adj, rels=rels, batch=batch,
                labels=labels, noise=np.random.default_rng(1).standard_normal(
                    ds.features.shape).astype(np.float32))


def sample_key(model, params, key):
    return model.apply(params, rngs={"sample": key},
                       method=lambda m: m.make_rng("sample"))


def t(a):
    return torch.as_tensor(np.asarray(a))


def port_tables(adjs):
    return [NeighborTable.from_scipy(a, device="cpu") for a in adjs]


def jax_grads_as_state(grads):
    return params_from_flax(jax.tree.map(np.asarray, grads))


def check_grads(port, loss, jgrads):
    loss.backward()
    want = jax_grads_as_state(jgrads)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)


def load(port, params):
    port.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return port


def test_synthetic_relations_equal_jax():
    jds = jax_synthetic.synthetic_gad(n_relations=3, **DS_KW)
    pds = pt_synthetic.synthetic_gad(n_relations=3, **DS_KW)
    assert len(pds.relations) == len(jds.relations) == 3
    for a, b in zip(pds.relations, jds.relations):
        for part in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, part),
                                          getattr(b, part))
    assert sum(r.nnz for r in pds.relations) == pds.adj.nnz
    np.testing.assert_array_equal(pds.features, jds.features)
    assert pt_synthetic.synthetic_gad(**DS_KW).relations is None


@pytest.mark.parametrize("n_rel,seed", [(2, 0), (4, 9)])
def test_split_relations_equal_jax(n_rel, seed):
    adj = pt_synthetic.synthetic_gad(**DS_KW).adj
    got = pt_synthetic.split_relations(adj, n_rel, seed=seed)
    want = jax_synthetic.split_relations(adj, n_rel, seed=seed)
    for a, b in zip(got, want):
        assert (a != b).nnz == 0 and a.dtype == b.dtype


def test_graphsage_classifier_matches_jax(data):
    jm = jax_sage.GraphSAGEClassifier(emb_dim=EMB, fanout=5)
    jt = JaxTable.from_scipy(data["adj"])
    feats, batch = jnp.asarray(data["feats"]), jnp.asarray(data["batch"])
    y = jnp.asarray(data["labels"])
    params = jm.init({"params": jax.random.PRNGKey(1),
                      "sample": jax.random.PRNGKey(2)}, feats, jt, batch)
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(sample_key(jm, params, key), (B + N_ANOM, 5))

    def loss_fn(p):
        logits = jm.apply(p, feats, jt, batch, rngs={"sample": key})
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn,
                                                  has_aux=True)(params)
    port = load(GraphSAGEClassifier(F, EMB, 5), params)
    logits = port(t(data["feats"]), port_tables([data["adj"]])[0],
                  t(data["batch"]), u=t(u))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=TOL,
                               atol=TOL)
    loss = torch.nn.functional.cross_entropy(logits, t(data["labels"]).long())
    assert float(loss) == pytest.approx(float(jloss), rel=TOL, abs=TOL)
    check_grads(port, loss, jgrads)


@pytest.mark.parametrize("relations", ["shared", "own"])
def test_pcgnn_matches_jax(data, relations):
    adjs = [data["adj"]] * 3 if relations == "shared" else data["rels"]
    jt = [JaxTable.from_scipy(a) for a in adjs]
    if relations == "shared":
        jt = [jt[0]] * 3
    jm = jax_pcgnn.PCGNN(emb_dim=EMB, n_relations=3, fanout1=5, fanout2=3)
    feats, batch = jnp.asarray(data["feats"]), jnp.asarray(data["batch"])
    y = jnp.asarray(data["labels"])
    params = jm.init({"params": jax.random.PRNGKey(4),
                      "sample": jax.random.PRNGKey(5)}, feats, jt, batch)
    key = jax.random.PRNGKey(6)
    rng, draws = sample_key(jm, params, key), []
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        r1, r2 = jax.random.split(sub)
        draws.append((t(jax.random.uniform(r1, (B + N_ANOM, 5))),
                      t(jax.random.uniform(r2, ((B + N_ANOM) * 5, 3)))))

    def loss_fn(p):
        out = jm.apply(p, feats, jt, batch, rngs={"sample": key})
        total, cls, margin = jax_pcgnn.pcgnn_loss(out, y)
        return total, (out, cls, margin, jax_pcgnn.pcgnn_prob(out))

    (jtotal, (jout, jcls, jmargin, jprob)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    port = load(PCGNN(F, EMB, 3, fanout1=5, fanout2=3), params)
    tables = port_tables(adjs)
    if relations == "shared":
        tables = [tables[0]] * 3
    out = port(t(data["feats"]), tables, t(data["batch"]), draws=draws)
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(pcgnn_prob(out).detach().numpy(), jprob,
                               rtol=TOL, atol=TOL)
    total, cls, margin = pcgnn_loss(out, t(data["labels"]))
    for got, want in ((total, jtotal), (cls, jcls), (margin, jmargin)):
        assert float(got) == pytest.approx(float(want), rel=TOL, abs=TOL)
    check_grads(port, total, jgrads)


def test_pcgnn_affinity_keeps_zero_rows_zero():
    """A zero embedding has affinity 0 (``pcgnn.py:79-81``), not NaN."""
    from ggad_tpu_torch.models.pcgnn import _l2n

    v = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    np.testing.assert_allclose(_l2n(v).numpy(), [[0, 0], [0.6, 0.8]])


@pytest.mark.parametrize("pos_weighted", [False, True])
def test_minibatch_recon_matches_jax(data, pos_weighted):
    jm = jax_recon.MiniBatchRecon(emb_dim=EMB, fanout=6,
                                  pos_weighted=pos_weighted)
    jt = JaxTable.from_scipy(data["adj"])
    feats, batch = jnp.asarray(data["feats"]), jnp.asarray(data["batch"])
    params = jm.init({"params": jax.random.PRNGKey(7),
                      "sample": jax.random.PRNGKey(8)}, feats, jt, batch)
    key = jax.random.PRNGKey(9)
    u = jax.random.uniform(sample_key(jm, params, key), (B + N_ANOM, 6))

    def loss_fn(p):
        x_rec = jm.apply(p, feats, jt, batch, rngs={"sample": key})
        return jm.train_loss(x_rec, feats[batch]), x_rec

    (jloss, jrec), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    port = load(MiniBatchRecon(F, EMB, 6, pos_weighted), params)
    x = t(data["feats"])
    x_rec = port(x, port_tables([data["adj"]])[0], t(data["batch"]), u=t(u))
    np.testing.assert_allclose(x_rec.detach().numpy(), jrec, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        MiniBatchRecon.scores(x_rec, x[t(data["batch"])]).detach().numpy(),
        jax_recon.MiniBatchRecon.scores(jrec, feats[batch]), rtol=TOL,
        atol=TOL)
    loss = port.train_loss(x_rec, x[t(data["batch"])])
    assert float(loss) == pytest.approx(float(jloss), rel=TOL, abs=TOL)
    check_grads(port, loss, jgrads)


def test_minibatch_aegis_matches_jax(data):
    jm = jax_recon.MiniBatchAEGIS(emb_dim=EMB, fanout=6, hid_dim=10)
    jt = JaxTable.from_scipy(data["adj"])
    feats, batch = jnp.asarray(data["feats"]), jnp.asarray(data["batch"])
    noise = jnp.asarray(data["noise"])
    params = jm.init({"params": jax.random.PRNGKey(10),
                      "sample": jax.random.PRNGKey(11)}, feats, noise, jt,
                     batch)
    key = jax.random.PRNGKey(12)
    u = jax.random.uniform(sample_key(jm, params, key), (B + N_ANOM, 6))

    def loss_fn(p):
        out = jm.apply(p, feats, noise, jt, batch, rngs={"sample": key})
        ld, lg = jax_recon.aegis_mb_losses(out)
        return ld + lg, (out, ld, lg)

    (_, (jout, jld, jlg)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    port = load(MiniBatchAEGIS(F, EMB, 6, 10), params)
    out = port(t(data["feats"]), t(data["noise"]),
               port_tables([data["adj"]])[0], t(data["batch"]), u=t(u))
    for got, want in ((out.probs_all, jout.probs_all),
                      (out.prob_noise, jout.prob_noise),
                      (out.prob_real, jout.prob_real)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                                   atol=TOL)
    ld, lg = aegis_mb_losses(out)
    assert float(ld) == pytest.approx(float(jld), rel=TOL, abs=TOL)
    assert float(lg) == pytest.approx(float(jlg), rel=TOL, abs=TOL)
    check_grads(port, ld + lg, jgrads)
