"""TAM's runner (``run_tam_baseline``) and CLI against
``ggad_tpu.train.baselines.run_tam_baseline``.

Both take JAX's cut values and stacked member init (through
``run_tam``'s keywords) on TAM's split and on the dataset's GGAD split;
the history (one AUROC/AP record a round, then the final one) and the
final AUROC/AP must match JAX's within 1e-4. JAX takes its ``ell`` route
on the CPU, so the port is forced onto its ``ell`` route here (the
``bcsr`` route is held to JAX's in ``test_torch_tam_run.py``). Then the
CLI: ``--model tam`` with ``--tam_split`` and ``--no-tam_split`` on
``--device cpu`` prints a record with JAX's keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.graph import add_self_loops as jax_add_self_loops
from ggad_tpu.graph import from_scipy as jax_from_scipy
from ggad_tpu.models import tam as jtam
from ggad_tpu.train import baselines as jb
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.train import baselines as tb

DS_KW = dict(n_nodes=300, avg_degree=8, feat_dim=16, anomaly_rate=0.1,
             seed=5)
KW = dict(n_h=12, cutting=3, n_tree=1, num_epoch=6, lr=1e-4, seed=0,
          eval_every=1)
TOL = 1e-4


@pytest.fixture(scope="module")
def overrides():
    """JAX's cut values (``tam.py:402-415``) and stacked member init."""
    ds = jax_synthetic_gad(**DS_KW)
    jraw = jax_add_self_loops(jax_from_scipy(ds.adj))
    x = jnp.asarray(ds.features)
    dis = jtam.edge_feature_distance(jraw, x)
    t_perm = jnp.asarray(jtam.transpose_permutation(jraw))
    rng, val, vals = jax.random.PRNGKey(0), jraw.val, []
    for _ in range(KW["cutting"]):
        rng, sub = jax.random.split(rng)
        val = jtam.nsgt_cut(val, dis, jraw, t_perm, sub)
        vals.append(val)
    keys = jax.random.split(jax.random.PRNGKey(1), KW["cutting"])
    params = jax.vmap(lambda k: jtam.TAMEncoder(n_h=KW["n_h"]).init(
        {"params": k}, jraw, x))(keys)
    return ds, np.asarray(jnp.stack(vals)), jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("use_tam_split", [True, False])
def test_run_tam_baseline_matches_jax(overrides, use_tam_split):
    jds, vals, params = overrides
    want = jb.run_tam_baseline(jds, use_tam_split=use_tam_split,
                               val_stack_override=vals,
                               member_params_override=params, **KW)
    got = tb.run_tam_baseline(synthetic_gad(**DS_KW),
                              use_tam_split=use_tam_split, val_stack=vals,
                              member_params=params, impl="ell",
                              device="cpu", **KW)
    assert [set(r) for r in got.history] == [set(r) for r in want.history]
    assert [r["round"] for r in got.history[:-1]] == [1, 2, 3]
    assert got.history[-1]["epoch"] == KW["num_epoch"]
    for g, w in zip(got.history, want.history):
        for k, v in w.items():
            assert g[k] == pytest.approx(v, rel=TOL, abs=TOL), (k, g, w)
    assert got.auc == pytest.approx(want.auc, rel=TOL, abs=TOL)
    assert got.ap == pytest.approx(want.ap, rel=TOL, abs=TOL)


def test_eval_every_takes_every_kth_round(overrides):
    _, vals, params = overrides
    kw = dict(KW, eval_every=2)
    res = tb.run_tam_baseline(synthetic_gad(**DS_KW), val_stack=vals,
                              member_params=params, device="cpu", **kw)
    assert [r.get("round") for r in res.history] == [1, 3, None]


@pytest.mark.parametrize("extra", [["--tam_split"], ["--no-tam_split"]])
def test_cli_tam_prints_jax_keys(extra, capsys, monkeypatch):
    """``--model tam`` reaches ``run_tam_baseline`` with the split flag and
    prints JAX's record keys."""
    seen = []
    real = tb.run_tam_baseline

    def spy(ds, **kw):
        seen.append(kw["use_tam_split"])
        return real(ds, **kw)

    monkeypatch.setattr(tb, "run_tam_baseline", spy)
    assert cli_main(["--dataset", "photo", "--synthetic_scale", "0.05",
                     "--model", "tam", "--num_epoch", "2",
                     "--embedding_dim", "16", "--device", "cpu"]
                    + extra) == 0
    assert seen == [extra == ["--tam_split"]]
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = jb.BaselineResult(0.0, 0.0, [], 0.0).as_dict("m", "d").keys()
    assert rec.keys() == keys and rec["model"] == "tam"
    assert 0.0 <= rec["auc"] <= 1.0
