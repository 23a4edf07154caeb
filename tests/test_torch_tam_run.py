"""TAM's ensemble (``run_tam``) against ``ggad_tpu.models.tam.run_tam``.

Both sides take JAX's cut values (its NSGT chain from seed 0, passed as
``val_stack`` / ``val_stack_override``) and JAX's stacked member init
(``member_params``, mapped by ``interop``), and record the per-member
losses of a few epochs. The port's ``bcsr`` route (K1's plain version on
the CPU) is held to JAX's ``bcsr`` (its Pallas kernel in interpret mode,
as JAX's own tests run it) and its ``ell`` route to JAX's ``ell``:
scores, per-round scores, member messages and recorded losses within
rtol 1e-4 / atol 1e-5, JAX's impl-equality tolerance
(``tests/test_baselines.py:173-191``). The JAX runs are shared by a
module-scope fixture. Then the port alone: member chunking changes no
result, the two routes agree, ``auto`` decides by the graph, the seeded
run is reproducible, and a block-diagonal failure raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggad_tpu.datasets.synthetic import synthetic_gad as jax_synthetic_gad
from ggad_tpu.graph import add_self_loops as jax_add_self_loops
from ggad_tpu.graph import from_scipy as jax_from_scipy
from ggad_tpu.models import tam as jtam
from ggad_tpu_torch.datasets.synthetic import synthetic_gad, synthetic_like
from ggad_tpu_torch.graph import add_self_loops, from_scipy
from ggad_tpu_torch.models import tam
from ggad_tpu_torch.ops import bcsr_spmm as pb

DS_KW = dict(n_nodes=300, avg_degree=8, feat_dim=16, anomaly_rate=0.08,
             seed=7)
KW = dict(n_h=12, cutting=3, n_tree=1, num_epoch=8, lr=1e-4, seed=0)
RECORD = (0, 3, 7)
RTOL, ATOL = 1e-4, 1e-5


def jax_cut_values(jraw, x, cutting, n_tree, seed=0):
    """JAX's cut stack exactly as ``run_tam`` builds it (``tam.py:402-415``)."""
    dis = jtam.edge_feature_distance(jraw, x)
    t_perm = jnp.asarray(jtam.transpose_permutation(jraw))
    rng = jax.random.PRNGKey(seed)
    vals, out = [jraw.val] * n_tree, []
    for _ in range(cutting):
        for t in range(n_tree):
            rng, sub = jax.random.split(rng)
            vals[t] = jtam.nsgt_cut(vals[t], dis, jraw, t_perm, sub)
            out.append(vals[t])
    return np.asarray(jnp.stack(out))


@pytest.fixture(scope="module")
def inputs():
    """(dataset, JAX's raw graph, the port's, cut values, member init)."""
    ds = jax_synthetic_gad(**DS_KW)
    jraw = jax_add_self_loops(jax_from_scipy(ds.adj))
    x = jnp.asarray(ds.features)
    vals = jax_cut_values(jraw, x, KW["cutting"], KW["n_tree"])
    keys = jax.random.split(jax.random.PRNGKey(1), KW["cutting"])
    params = jax.vmap(lambda k: jtam.TAMEncoder(n_h=KW["n_h"]).init(
        {"params": k}, jraw, x))(keys)
    traw = add_self_loops(from_scipy(synthetic_gad(**DS_KW).adj,
                                     device="cpu"))
    return ds, jraw, traw, vals, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    ds, jraw, _, vals, params = inputs
    memo = {}

    def get(impl):
        if impl not in memo:
            memo[impl] = jtam.run_tam(
                None, jraw, ds.features, ds.normal_label_idx, impl=impl,
                val_stack_override=vals, member_params_override=params,
                loss_record=RECORD, **KW)
        return memo[impl]

    return get


def port_run(inputs, **kw):
    ds, _, traw, vals, params = inputs
    return tam.run_tam(traw, ds.features, ds.normal_label_idx,
                       val_stack=vals, member_params=params,
                       loss_record=RECORD, **{**KW, **kw})


def assert_results_close(got, want, rtol=RTOL, atol=ATOL):
    for field in ("scores", "per_round_scores", "member_messages"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=rtol, atol=atol, err_msg=field)
    assert set(got.loss_history) == set(want.loss_history)
    for ep, losses in want.loss_history.items():
        np.testing.assert_allclose(got.loss_history[ep], losses, rtol=rtol,
                                   atol=atol, err_msg=f"epoch {ep}")


@pytest.mark.parametrize("impl", ["bcsr", "ell"])
def test_run_tam_matches_jax(inputs, jax_runs, impl):
    got = port_run(inputs, impl=impl)
    assert got.per_round_scores.shape == (KW["cutting"], DS_KW["n_nodes"])
    assert sorted(got.loss_history) == list(RECORD)
    assert_results_close(got, jax_runs(impl))


@pytest.mark.parametrize("impl", ["bcsr", "ell"])
def test_member_chunk_changes_nothing(inputs, impl):
    whole = port_run(inputs, impl=impl)
    one = port_run(inputs, impl=impl, member_chunk=1)
    assert_results_close(one, whole, rtol=1e-6, atol=1e-7)


def test_routes_agree_and_bcsr_counts_its_launches(inputs):
    """The two routes agree; on the CPU the block-diagonal route takes
    K1's plain version, so the launch counter stays."""
    before = pb.bcsr_spmm.launches
    bcsr = port_run(inputs, impl="bcsr")
    assert pb.bcsr_spmm.launches == before
    assert_results_close(bcsr, port_run(inputs, impl="ell"))


def test_auto_decides_by_the_graph():
    dense = add_self_loops(from_scipy(synthetic_gad(**DS_KW).adj,
                                      device="cpu"))
    sparse = add_self_loops(from_scipy(
        synthetic_like("elliptic", scale=0.3).adj, device="cpu"))
    assert tam.tam_route(dense) == tam.tam_route(dense, "auto") == "bcsr"
    assert tam.tam_route(sparse) == "ell"
    assert tam.tam_route(sparse, "bcsr") == "bcsr"
    with pytest.raises(ValueError, match="impl"):
        tam.tam_route(dense, "coo")


def test_seeded_run_is_reproducible_and_takes_its_draws(inputs):
    """Without cut values or weights the run draws both from a generator
    seeded with ``seed``: the same seed gives the same result on either
    route; given ``draws`` it cuts from them instead."""
    ds, _, traw, _, _ = inputs
    kw = dict(KW, num_epoch=2)
    runs = [tam.run_tam(traw, ds.features, ds.normal_label_idx, impl=impl,
                        **kw) for impl in ("bcsr", "ell", "bcsr")]
    np.testing.assert_array_equal(runs[0].scores, runs[2].scores)
    np.testing.assert_allclose(runs[0].scores, runs[1].scores, rtol=RTOL,
                               atol=ATOL)
    other = tam.run_tam(traw, ds.features, ds.normal_label_idx,
                        **dict(kw, seed=1))
    assert not np.allclose(other.scores, runs[0].scores)

    gen = torch.Generator().manual_seed(0)
    tam.init_members(ds.feat_dim, kw["n_h"], kw["cutting"], gen)
    draws = [torch.rand(ds.n_nodes, generator=gen)
             for _ in range(kw["cutting"])]
    given = tam.run_tam(traw, ds.features, ds.normal_label_idx, impl="bcsr",
                        draws=draws, **kw)
    np.testing.assert_array_equal(given.scores, runs[0].scores)


def test_blockdiag_failure_raises(inputs, monkeypatch):
    """A failure of the block-diagonal route surfaces; the run does not
    fall back to ELL (JAX's remote-compile fallback is not carried)."""
    def boom(*a, **k):
        raise RuntimeError("block-diagonal build failed")

    monkeypatch.setattr(tam, "blockdiag_pair", boom)
    with pytest.raises(RuntimeError, match="block-diagonal"):
        port_run(inputs, impl="bcsr")
