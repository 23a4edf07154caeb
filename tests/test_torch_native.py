"""The port's host library (``ggad_tpu_torch/native.py`` over
``ggad_tpu_torch/csrc/graphbuild.cpp``) against ``ggad_tpu.native`` and
against the port's Python routes, on small seeded graphs (mirrors
``tests/test_native.py``).

Each entry point gives the arrays of JAX's binding (the same C++) and of
the Python/numpy route its caller takes on a host with no compiler; the
partitions give equal labels on the native route, the Python route and
through ``ggad_tpu.datasets.partition``. A compile that fails raises, and
two processes building at once leave one loadable library.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from ggad_tpu import native as jnative
from ggad_tpu.datasets import partition as jpart
from ggad_tpu_torch import native
from ggad_tpu_torch.datasets import partition as tpart
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import from_coo
from ggad_tpu_torch.ops import _build
from ggad_tpu_torch.ops.bcsr_spmm import bcsr_from_coo

REPO = Path(__file__).resolve().parents[1]
N = 200


@pytest.fixture
def coo(rng):
    """2,000 random edges on 200 nodes, 300 of them repeated (with other
    values), so every sort and sum meets duplicate pairs."""
    r = rng.integers(0, N, 2000).astype(np.int32)
    c = rng.integers(0, N, 2000).astype(np.int32)
    v = rng.random(2000).astype(np.float32)
    dup = rng.integers(0, 2000, 300)
    return (np.concatenate([r, r[dup]]), np.concatenate([c, c[dup]]),
            np.concatenate([v, rng.random(300).astype(np.float32)]))


@pytest.fixture
def python_route(monkeypatch):
    """A host with no C++ compiler: ``native.available()`` is False."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "cxx_path", lambda: None)


def test_sort_coo_equals_jax_and_lexsort_with_duplicates(coo):
    r, c, v = coo
    rs, cs, vs = native.sort_coo(r, c, v)
    jr, jc, jv = jnative.sort_coo(r, c, v)
    order = np.lexsort((c, r))
    for got, ref in ((rs, jr), (cs, jc), (vs, jv), (rs, r[order]),
                     (cs, c[order]), (vs, v[order])):
        np.testing.assert_array_equal(got, ref)
    assert rs.dtype == np.int32 and vs.dtype == np.float32
    rs, cs, vs = native.sort_coo(r, c, None)
    assert vs is None
    np.testing.assert_array_equal(cs, c[order])


def test_from_coo_native_sort_equals_python_route(monkeypatch):
    """Above 1M edges ``from_coo`` sorts natively; duplicate pairs keep
    their input order, so the graph equals the ``np.lexsort`` route's."""
    rng = np.random.default_rng(3)
    e = 1_000_200
    r = rng.integers(0, 1000, e)
    c = rng.integers(0, 1000, e)       # 1M slots: many pairs repeat
    v = rng.random(e).astype(np.float32)
    before = native.calls["sort_coo"]
    g = from_coo(r, c, v, 1000, device="cpu")
    assert native.calls["sort_coo"] == before + 1
    monkeypatch.setattr(native, "available", lambda: False)
    p = from_coo(r, c, v, 1000, device="cpu")
    assert native.calls["sort_coo"] == before + 1
    for name in ("row", "col", "val", "indptr"):
        assert getattr(g, name).dtype == getattr(p, name).dtype
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      getattr(p, name).numpy())


def test_symmetrize_and_indptr_equal_jax_and_scipy(coo):
    r, c, v = coo
    sr, sc, sv = native.symmetrize(r, c, v)
    for got, ref in zip((sr, sc, sv), jnative.symmetrize(r, c, v)):
        np.testing.assert_array_equal(got, ref)
    # the scipy route (synthetic.py below 200,000 nodes): unit values
    sr, sc, sv = native.symmetrize(r, c, None)
    a = sp.coo_matrix((np.ones(len(r), np.float32), (r, c)), shape=(N, N))
    a = a.maximum(a.T)
    a.data[:] = 1.0
    a = a.tocsr()
    indptr = native.build_indptr(sr, N)
    np.testing.assert_array_equal(indptr, jnative.build_indptr(sr, N))
    np.testing.assert_array_equal(indptr, a.indptr)
    np.testing.assert_array_equal(sc, a.indices)
    np.testing.assert_array_equal(sv, a.data)


def test_synthetic_native_route_equals_scipy_route_and_jax(monkeypatch):
    """From 200,000 nodes the generator symmetrizes natively (as JAX's
    does); the scipy route builds the same matrix."""
    from ggad_tpu.datasets.synthetic import synthetic_gad as j_synthetic

    kw = dict(n_nodes=200_000, avg_degree=2, feat_dim=2, n_communities=4,
              seed=5)
    before = dict(native.calls)
    nat = synthetic_gad(**kw).adj
    assert native.calls["symmetrize"] == before["symmetrize"] + 1
    assert native.calls["build_indptr"] == before["build_indptr"] + 1
    jax = j_synthetic(**kw).adj
    monkeypatch.setattr(native, "available", lambda: False)
    py = synthetic_gad(**kw).adj
    for ref in (py, jax):
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(nat, name),
                                          getattr(ref, name))


def test_sym_normalize_vals_equals_jax_and_the_torch_route(coo):
    import torch

    from ggad_tpu_torch.models.tam import sym_normalize_vals

    r, c, v = coo
    got = native.sym_normalize_vals(r, c, v, N)
    np.testing.assert_array_equal(got, jnative.sym_normalize_vals(r, c, v,
                                                                  N))
    # the port's Python route (TAM's, column-sum degrees: the same on a
    # symmetric graph), in f32 against the library's f64 degrees
    sr, sc, sv = native.symmetrize(r, c, v)
    g = from_coo(sr, sc, sv, N, device="cpu")
    ref = sym_normalize_vals(g.val, g)[:g.n_edges].numpy()
    np.testing.assert_allclose(native.sym_normalize_vals(sr, sc, sv, N), ref,
                               rtol=1e-6, atol=0)
    assert torch.isfinite(g.val).all()


@pytest.mark.parametrize("n", [N, 300])
def test_bcsr_tiles_equal_numpy_route_and_jax(coo, monkeypatch, n):
    """``bcsr_from_coo`` at tile height 128 takes ``native.bcsr_build``;
    its store (duplicates added in input order) equals the ``np.add.at``
    route's and JAX's binding's, element for element."""
    r, c, v = coo
    before = native.calls["bcsr_build"]
    got = bcsr_from_coo(r, c, v, n, device="cpu")
    assert native.calls["bcsr_build"] == before + 1
    jr, jc, jv = jnative.bcsr_build(r, c, v, -(-n // 128))
    monkeypatch.setattr(native, "available", lambda: False)
    py = bcsr_from_coo(r, c, v, n, device="cpu")
    assert native.calls["bcsr_build"] == before + 1
    for name in ("tile_rows", "tile_cols", "tile_ptr", "values", "row_ptr",
                 "col", "val"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(py, name).numpy())
    np.testing.assert_array_equal(got.tile_rows.numpy(), jr)
    np.testing.assert_array_equal(got.tile_cols.numpy(), jc)
    np.testing.assert_array_equal(got.values.numpy(), jv)
    # a taller tile keeps the numpy route
    monkeypatch.undo()
    bcsr_from_coo(r, c, v, n, tile_rows=256, device="cpu")
    assert native.calls["bcsr_build"] == before + 1


def test_host_samples_are_valid_and_equal_jax(coo):
    r, c, v = coo
    rs, cs, _ = native.sort_coo(r, c, v)
    indptr = native.build_indptr(rs, N)
    query = np.arange(60, dtype=np.int32)
    query[-5:] = N - 1                 # repeated queries
    empty = np.flatnonzero(np.diff(indptr) == 0)
    neigh, mask = native.sample_neighbors_host(query, indptr, cs, 8, seed=1)
    jn, jm = jnative.sample_neighbors_host(query, indptr, cs, 8, seed=1)
    np.testing.assert_array_equal(neigh, jn)
    np.testing.assert_array_equal(mask, jm)
    dense = np.zeros((N, N), bool)
    dense[rs, cs] = True
    for i, q in enumerate(query):
        if q in empty:
            assert (neigh[i] == q).all() and (mask[i] == 0).all()
        else:
            assert (mask[i] == 1).all() and dense[q, neigh[i]].all()
    # an isolated node: itself, mask 0
    n2, m2 = native.sample_neighbors_host(np.array([0], np.int32),
                                          np.zeros(2, np.int32),
                                          np.zeros(0, np.int32), 4)
    assert (n2 == 0).all() and (m2 == 0).all()


def _weighted(n=300, seed=6):
    mat = sp.random(n, n, density=0.05, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(seed))
    return sp.csr_matrix(mat + mat.T)


@pytest.mark.parametrize("D", [2, 4])
def test_partition_refine_native_python_and_jax(D):
    a = _weighted()
    part0 = np.random.default_rng(D).integers(0, D, 300).astype(np.int32)
    node_w = np.random.default_rng(1).integers(1, 4, 300).astype(np.int32)
    for weights, nw in ((None, None), (a.data, None), (a.data, node_w)):
        total = 300 if nw is None else int(nw.sum())
        cap = int(np.ceil(1.02 * total / D)) + 40
        kw = dict(rounds=5, seed=9, weights=weights, node_w=nw)
        got = native.partition_refine(a.indptr, a.indices, part0, D, cap,
                                      **kw)
        np.testing.assert_array_equal(got, tpart.partition_refine_python(
            a.indptr, a.indices, part0, D, cap, **kw))
        np.testing.assert_array_equal(got, jnative.partition_refine(
            a.indptr, a.indices, part0, D, cap, **kw))
        np.testing.assert_array_equal(got, tpart.partition_refine(
            a.indptr, a.indices, part0, D, cap, **kw))
        assert (got != part0).any()


def test_hem_match_native_python_and_jax():
    a = _weighted(seed=2)
    for weights in (None, a.data):
        for seed in (1, 5):
            got = native.hem_match(a.indptr, a.indices, weights, seed=seed)
            np.testing.assert_array_equal(got, tpart.hem_match_python(
                a.indptr, a.indices, weights, seed=seed))
            np.testing.assert_array_equal(got, jnative.hem_match(
                a.indptr, a.indices, weights, seed=seed))
            np.testing.assert_array_equal(got[got], np.arange(300))


@pytest.mark.parametrize("fn", ["lp_partition", "multilevel_partition"])
@pytest.mark.parametrize("D", [2, 4])
def test_partitions_equal_on_all_three_routes(fn, D, monkeypatch):
    """Native route, Python route (no compiler) and JAX's partitioner
    give the same labels; the native route calls the library."""
    adj = synthetic_gad(n_nodes=700, avg_degree=8, feat_dim=4,
                        n_communities=5, seed=D).adj
    block = -(-700 // D)
    before = dict(native.calls)
    nat = getattr(tpart, fn)(adj, D, seed=1, exact_block=block)
    assert native.calls["partition_refine"] > before["partition_refine"]
    if fn == "multilevel_partition":
        assert native.calls["hem_match"] > before["hem_match"]
    jax = getattr(jpart, fn)(adj, D, seed=1, exact_block=block)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "cxx_path", lambda: None)
    assert not native.available()
    after = dict(native.calls)
    py = getattr(tpart, fn)(adj, D, seed=1, exact_block=block)
    assert native.calls == after
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, jax)


def test_no_compiler_entry_points_raise(python_route):
    """Without a compiler the library is unavailable and its entry points
    raise; the callers take their Python routes (above)."""
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.sort_coo(np.zeros(3, np.int32), np.zeros(3, np.int32), None)


def test_compile_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output,
    at the entry point and at a caller: nothing falls back."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "graphbuild.cpp").write_text("int gg_sort_coo( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    with pytest.raises(RuntimeError, match="failed for graphbuild.cpp") as e:
        native.sort_coo(np.zeros(3, np.int32), np.zeros(3, np.int32), None)
    assert "error" in str(e.value)
    a = _weighted()
    with pytest.raises(RuntimeError, match="failed for graphbuild.cpp"):
        tpart.partition_refine(a.indptr, a.indices,
                               np.zeros(300, np.int32), 2, 200)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


BUILDER = r"""
import sys
from pathlib import Path
from ggad_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
path, _ = _build.build_host("graphbuild")
print(path)
"""


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(*paths).name]
    lib = ctypes.CDLL(paths.pop())
    rows = (ctypes.c_int32 * 3)(2, 0, 1)
    cols = (ctypes.c_int32 * 3)(0, 1, 2)
    assert lib.gg_sort_coo(ctypes.c_int64(3), rows, cols, None) == 0
    assert list(rows) == [0, 1, 2] and list(cols) == [1, 2, 0]


def test_library_name_hashes_source_flags_and_compiler(tmp_path,
                                                       monkeypatch):
    cxx = _build.cxx_path()
    path = _build.host_library_path("graphbuild", cxx)
    assert path.parent == _build.BUILD_DIR
    assert "-march=native" not in _build.HOST_FLAGS
    monkeypatch.setattr(_build, "HOST_FLAGS", (*_build.HOST_FLAGS, "-g"))
    assert _build.host_library_path("graphbuild", cxx) != path
