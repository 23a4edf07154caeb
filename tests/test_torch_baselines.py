"""The baseline zoo's runners against ``ggad_tpu.train.baselines``.

Same dataset (the port's synthetic generator is a bit-identical copy),
same initial weights (JAX's init, mapped by ``interop``) and, for AEGIS
and GAAN, the same noise (numpy draws passed to both as ``noise_seq``).
Each runner's ``history`` (every evaluation's loss, AUROC and AP, and
AEGIS's pretrain losses) must match JAX's to 1e-4 rel/abs on each of the
port's routes: ``coo``, ``bcsr`` and ``ell`` (the CPU plain versions; JAX
takes its XLA path on the CPU, the same function). The JAX runs are shared
by module-scope fixtures. Then the CLI: each baseline ``--model`` on
``--device cpu`` prints a record with JAX's keys.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.models.aegis import AEGIS as JaxAEGIS
from ggad_tpu.models.anomaly_dae import AnomalyDAE as JaxAnomalyDAE
from ggad_tpu.models.dominant import Dominant as JaxDominant
from ggad_tpu.models.gaan import GAAN as JaxGAAN
from ggad_tpu.models.ocgnn import OCGNNEncoder as JaxOCGNN
from ggad_tpu.train import baselines as jb
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import Graph
from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph
from ggad_tpu_torch.ops.ell_spmm import ELLGraph
from ggad_tpu_torch.train import baselines as tb

N_H = 16
EPOCHS = 4
PRETRAIN = 2
DS_KW = dict(n_nodes=240, avg_degree=8, feat_dim=20, n_communities=3,
             anomaly_rate=0.1, seed=4)
TOL = 1e-4
ROUTES = ("coo", "bcsr", "ell")
GRAPH_TYPE = {"coo": Graph, "bcsr": BCSRGraph, "ell": ELLGraph}
# (runner, variant): the keywords that set the variant
CASES = {
    ("dominant", None): dict(),
    ("anomalydae", None): dict(),
    ("ocgnn", "plain"): dict(use_warmup=False),
    ("ocgnn", "warmup"): dict(use_warmup=True),
    ("aegis", "intended"): dict(faithful=False),
    ("aegis", "faithful"): dict(faithful=True),
    ("gaan", "intended"): dict(faithful=False),
    ("gaan", "faithful"): dict(faithful=True),
}


@pytest.fixture(scope="module")
def jax_ds():
    return jax_synthetic_gad(**DS_KW)


@pytest.fixture(scope="module")
def jax_params(jax_ds):
    adj, _, x, _ = jb._prep(jax_ds)
    key = jax.random.PRNGKey(1)
    rngs = {"params": key, "noise": key}
    params = {
        "dominant": JaxDominant(n_h=N_H).init(key, adj, x),
        "anomalydae": JaxAnomalyDAE(n_h=N_H).init(key, adj, x),
        "ocgnn": JaxOCGNN(n_h=N_H).init(key, adj, x),
        "aegis": JaxAEGIS(n_h=N_H).init(rngs, adj, x),
        "gaan": JaxGAAN().init(rngs, x),
    }
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def noise_seq():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((DS_KW["n_nodes"], 16)).astype(np.float32)
            for _ in range(PRETRAIN + EPOCHS)]


def run(pkg, name, ds, params, noise, **kw):
    """One runner of ``pkg`` (``jb`` or ``tb``) on the case's settings."""
    common = dict(num_epoch=EPOCHS, eval_every=2, initial_params=params,
                  **kw)
    if name in ("dominant", "anomalydae"):
        return pkg.run_reconstruction(name, ds, embedding_dim=N_H, **common)
    if name == "ocgnn":
        return pkg.run_ocgnn(ds, embedding_dim=N_H, **common)
    if name == "aegis":
        return pkg.run_aegis(ds, embedding_dim=N_H,
                             recon_num_epoch=PRETRAIN, noise_seq=noise,
                             **common)
    return pkg.run_gaan(ds, noise_seq=noise[PRETRAIN:], **common)


@pytest.fixture(scope="module")
def jax_history(jax_ds, jax_params, noise_seq):
    memo = {}

    def get(case):
        if case not in memo:
            name = case[0]
            memo[case] = run(jb, name, jax_ds, jax_params[name], noise_seq,
                             **CASES[case]).history
        return memo[case]

    return get


def assert_history_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k in ("epoch", "pretrain_epoch"):
                assert g[k] == v
            else:
                assert g[k] == pytest.approx(v, rel=TOL, abs=TOL), (k, g, w)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", list(CASES), ids=lambda c: "-".join(
    str(p) for p in c if p))
def test_runner_history_matches_jax(case, route, jax_history, jax_params,
                                    noise_seq):
    name = case[0]
    res = run(tb, name, synthetic_gad(**DS_KW), jax_params[name], noise_seq,
              spmm_impl=route, device="cpu", **CASES[case])
    want = jax_history(case)
    assert_history_close(res.history, want)
    assert res.auc == pytest.approx(want[-1]["auc"], abs=TOL)
    assert res.ap == pytest.approx(want[-1]["ap"], abs=TOL)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cls,transpose", [
    (tb.ReconstructionRun, False), (tb.OCGNNRun, True), (tb.AEGISRun, True),
    (tb.GAANRun, False)])
def test_runs_take_the_route_and_build_transposes_only_for_gcns(
        cls, transpose, route):
    """The graph takes ``maybe_bcsr``'s route; only OCGNN and AEGIS, whose
    GCNs read adj with a gradient, build the transposed tiles or table."""
    ds = synthetic_gad(**DS_KW)
    args = ("dominant", ds) if cls is tb.ReconstructionRun else (ds,)
    r = cls(*args, spmm_impl=route, device="cpu",
            **({} if cls is tb.GAANRun else {"embedding_dim": N_H}))
    assert type(r.adj) is GRAPH_TYPE[route]
    if route != "coo":
        pair = r.adj.tiles if route == "bcsr" else r.adj.tables
        assert (pair.bwd is not None) == transpose


def test_seeded_init_and_noise_are_reproducible():
    """Without ``initial_params`` / ``noise_seq`` the runner's weights and
    draws come from generators seeded with ``seed``: equal seeds give equal
    runs, another seed another run."""
    ds = synthetic_gad(**DS_KW)
    kw = dict(num_epoch=2, eval_every=1, recon_num_epoch=1,
              embedding_dim=N_H, device="cpu")
    a, b, c = (tb.run_aegis(ds, seed=s, **kw).history for s in (0, 0, 1))
    assert a == b
    assert a != c


def test_cli_baselines_print_jax_keys(capsys):
    args = ["--dataset", "elliptic", "--synthetic_scale", "0.005",
            "--num_epoch", "2", "--eval_every", "1", "--embedding_dim",
            "16", "--device", "cpu"]
    keys = jb.BaselineResult(0.0, 0.0, [], 0.0).as_dict("m", "d").keys()
    for model in tb.BASELINES:
        assert cli_main(args + ["--model", model]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec.keys() == keys and rec["model"] == model
        assert 0.0 <= rec["auc"] <= 1.0


@pytest.mark.parametrize("extra", [[], ["--aegis_faithful"]])
def test_cli_aegis_faithful_flag(extra, capsys, monkeypatch):
    """``--aegis_faithful`` reaches ``run_aegis`` as ``faithful``."""
    seen = []
    real = tb.run_aegis

    def spy(ds, **kw):
        seen.append(kw["faithful"])
        return real(ds, **kw)

    monkeypatch.setattr(tb, "run_aegis", spy)
    assert cli_main(["--dataset", "elliptic", "--synthetic_scale", "0.005",
                     "--model", "aegis", "--num_epoch", "1",
                     "--embedding_dim", "16", "--device", "cpu"]
                    + extra) == 0
    assert seen == [bool(extra)]
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["model"] == "aegis"


def test_run_baseline_rejects_unported_models():
    """Every model of ``ggad_tpu``'s CLI is ported: only a name that no
    package knows is refused."""
    args = type("A", (), dict(num_epoch=1, lr=None, seed=0, eval_every=1,
                              spmm_impl="coo", device="cpu"))()
    with pytest.raises(ValueError, match="unknown model"):
        tb.run_baseline("no-such-model", synthetic_gad(**DS_KW), args)


def test_run_baseline_dispatches_pcgnn_with_jax_keys():
    """``run_baseline("pcgnn", …)`` trains the minibatch classifier
    (``baselines.py:573-575``) and returns JAX's record keys."""
    args = type("A", (), dict(num_epoch=1, lr=None, seed=0, eval_every=1,
                              spmm_impl="coo", device="cpu",
                              checkpoint_dir=None))()
    got = tb.run_baseline("pcgnn", synthetic_gad(**DS_KW), args)
    want = jb.run_baseline("pcgnn", jax_synthetic_gad(**DS_KW), args)
    assert set(got) == set(want)
    assert got["model"] == "pcgnn" and got["dataset"] == want["dataset"]
    assert all(np.isfinite(got[k]) for k in ("best_val_auc", "test_auc",
                                             "test_ap"))


def test_faithful_aegis_pretrain_accumulates_gradients():
    """faithful pretraining never zeroes the gradients: after two pretrain
    epochs each gradient is the sum of both epochs' (JAX's ``grad_acc``);
    the intended mode keeps only the last epoch's. Both modes take the
    same first step, so the second epoch's gradient is the same."""
    ds = synthetic_gad(**DS_KW)
    noise = [np.full((DS_KW["n_nodes"], 16), 0.5, np.float32)] * 2
    grads = {}
    for faithful in (False, True):
        r = tb.AEGISRun(ds, embedding_dim=N_H, faithful=faithful,
                        noise_seq=noise, device="cpu")
        w = r.model.gcn_dec2.fc.weight
        r.pretrain_step()
        first = w.grad.clone()
        r.pretrain_step()
        grads[faithful] = (first, w.grad.clone())
    (f0, f1), (t0, t1) = grads[False], grads[True]
    torch.testing.assert_close(t0, f0)
    torch.testing.assert_close(t1, t0 + f1)
    assert not torch.allclose(t1, f1)


@pytest.mark.parametrize("noise", [False, True])
def test_a_finished_run_is_freed_without_garbage_collection(noise):
    """A run holds no reference cycle (its noise source closes over the
    device, not the run), so its tensors go when its last reference does,
    not at the next garbage collection. (The first optimizer a process
    builds imports torch's compiler stack, whose import keeps the frame
    that built it alive; one is built first.)"""
    import gc
    import weakref

    torch.optim.Adam([torch.zeros(1, requires_grad=True)])
    ds = synthetic_gad(**DS_KW)
    seq = [np.zeros((DS_KW["n_nodes"], 16), np.float32)] if noise else None
    gc.disable()
    try:
        run_ = tb.GAANRun(ds, noise_seq=seq, device="cpu")
        run_.step()
        ref = weakref.ref(run_)
        del run_
        assert ref() is None
    finally:
        gc.enable()
