"""Port graph building and normalization against ``ggad_tpu``: edge lists
equal exactly, values to 1e-6 (f32 degree sums in another order)."""

import numpy as np
import pytest
import scipy.sparse as sp

import ggad_tpu.graph as jg
import ggad_tpu.ops.normalize as jn
import ggad_tpu_torch.graph as pg
import ggad_tpu_torch.ops.normalize as pn


def random_adj(n, density, seed, self_loops=False):
    a = sp.random(n, n, density=density, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(seed))
    a = ((a + a.T) > 0).astype(np.float32)
    if not self_loops:
        a.setdiag(0)
        a.eliminate_zeros()
    return sp.csr_matrix(a)


def assert_same_graph(p, j, rtol=0.0):
    assert (p.n_nodes, p.n_edges, p.e_pad) == (j.n_nodes, j.n_edges, j.e_pad)
    np.testing.assert_array_equal(p.row.numpy(), np.asarray(j.row))
    np.testing.assert_array_equal(p.col.numpy(), np.asarray(j.col))
    np.testing.assert_array_equal(p.indptr.numpy(), np.asarray(j.indptr))
    np.testing.assert_allclose(p.val.numpy(), np.asarray(j.val),
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("n,density,seed,loops", [
    (60, 0.1, 0, False), (250, 0.03, 1, False), (400, 0.02, 2, True)])
def test_from_scipy_and_self_loops(n, density, seed, loops):
    a = random_adj(n, density, seed, loops)
    p = pg.from_scipy(a, device="cpu")
    j = jg.from_scipy(a)
    assert_same_graph(p, j)
    # an existing self-loop gets a duplicate edge, not a merged one
    assert_same_graph(pg.add_self_loops(p), jg.add_self_loops(j))


@pytest.mark.parametrize("n,density,seed", [(60, 0.1, 0), (300, 0.02, 4)])
def test_normalize_adj_reference(n, density, seed):
    a = random_adj(n, density, seed)
    a = a.tolil()
    a[5, :] = 0                     # an isolated node: d^{-1/2} guard
    a[:, 5] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    p_adj, p_raw = pn.normalize_adj_reference(pg.from_scipy(a, device="cpu"))
    j_adj, j_raw = jn.normalize_adj_reference(jg.from_scipy(a))
    assert_same_graph(p_adj, j_adj, rtol=1e-6)
    assert_same_graph(p_raw, j_raw)
    np.testing.assert_allclose(p_raw.out_degrees().numpy(),
                               np.asarray(j_raw.out_degrees()), rtol=1e-6)


def test_row_normalize_features():
    x = np.random.default_rng(0).random((30, 7)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_array_equal(pn.row_normalize_features(x),
                                  jn.row_normalize_features(x))


def test_from_coo_pads_with_zero_edges():
    g = pg.from_coo(np.array([2, 0, 1]), np.array([1, 2, 0]), None, 3,
                    pad_multiple=8, device="cpu")
    assert g.e_pad == 8 and g.n_edges == 3
    assert g.row.tolist() == [0, 1, 2, 0, 0, 0, 0, 0]
    assert g.val[3:].abs().sum().item() == 0.0
