"""Random walks with restart and ``pick_step`` against
``ggad_tpu.sampler.rwr``, from JAX's own draws.

``rwr_traces`` splits its key into one key a step and each step's key in
two (the offset's, the restart's): the test makes those draws and passes
them in. ``pick_step``'s draw is the ``uniform(key, (size,))`` that
``jax.random.choice`` makes. The graph has isolated nodes, so zero-degree
seeds stay put. Every id and mask is exactly equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ggad_tpu.sampler import rwr as jax_rwr
from ggad_tpu.sampler.neighbor import NeighborTable as JaxTable
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.sampler import rwr
from ggad_tpu_torch.sampler.neighbor import NeighborTable

N = 300
ISOLATED = (10, 11, 12)


@pytest.fixture(scope="module")
def tables():
    adj = synthetic_gad(n_nodes=N, avg_degree=6, feat_dim=4,
                        seed=3).adj.tocsr()
    keep = np.ones(N, np.float32)
    keep[list(ISOLATED)] = 0.0
    d = sp.diags(keep)
    adj = (d @ adj @ d).tocsr()
    adj.eliminate_zeros()
    adj.sort_indices()
    return NeighborTable.from_scipy(adj, device="cpu"), \
        JaxTable.from_scipy(adj)


def seeds():
    s = np.random.default_rng(0).choice(N, 40, replace=False)
    s[:3] = ISOLATED
    return s.astype(np.int32)


def walk_draws(key, walk_len, s):
    """JAX's per-step draws (``rwr.py:31-41``): [walk_len, S] each."""
    u_step, u_restart = [], []
    for k in jax.random.split(key, walk_len):
        k1, k2 = jax.random.split(k)
        u_step.append(np.asarray(jax.random.uniform(k1, (s,))))
        u_restart.append(np.asarray(jax.random.uniform(k2, (s,))))
    return torch.as_tensor(np.stack(u_step)), \
        torch.as_tensor(np.stack(u_restart))


@pytest.mark.parametrize("restart", [0.3, 0.0])
def test_rwr_traces_equal_jax(tables, restart):
    pt, jt = tables
    s = seeds()
    key = jax.random.PRNGKey(5)
    want = jax_rwr.rwr_traces(jt, jnp.asarray(s), 15, restart, key)
    got = rwr.rwr_traces(pt, torch.as_tensor(s), restart,
                         *walk_draws(key, 15, len(s)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(3):                            # zero-degree seeds
        assert (got[i] == int(s[i])).all()


@pytest.mark.parametrize("size,walk_len", [(4, 12), (8, None)])
def test_rwr_subgraphs_equal_jax(tables, size, walk_len):
    pt, jt = tables
    s = seeds()
    key = jax.random.PRNGKey(6)
    wl = walk_len or 3 * size
    want_nodes, want_mask = jax_rwr.rwr_subgraphs(
        jt, jnp.asarray(s), subgraph_size=size, restart_prob=0.5,
        walk_len=walk_len, rng=key)
    nodes, mask = rwr.rwr_subgraphs(pt, torch.as_tensor(s),
                                    subgraph_size=size, restart_prob=0.5,
                                    **dict(zip(("u_step", "u_restart"),
                                               walk_draws(key, wl, len(s)))))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(want_nodes))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert nodes.dtype == torch.int32 and mask.dtype == torch.float32
    assert (mask[:3].sum(1) == 1).all()           # isolated: the seed alone


@pytest.mark.parametrize("size,seed", [(500, 0), (64, 3)])
def test_pick_step_equals_jax(tables, size, seed):
    pt, _ = tables
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(N, 120, replace=False)).astype(np.int32)
    y = (rng.random(120) < 0.1).astype(np.int32)
    deg = np.diff(pt.indptr.numpy())[idx].astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = jax_rwr.pick_step(jnp.asarray(idx), jnp.asarray(y),
                             jnp.asarray(deg), size, key)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (size,))))
    got = rwr.pick_step(torch.as_tensor(idx), torch.as_tensor(y),
                        torch.as_tensor(deg), u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.isin(got.numpy(), idx[deg == 0]).any()
