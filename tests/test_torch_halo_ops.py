"""The halo ops on the local communicator against
``ggad_tpu.parallel.spmm_shard`` on the 8-virtual-device CPU mesh.

Both sides partition one graph (a scipy matrix with float32 weights and
self-loops) over D shards, take the same seeded inputs and compute the
op and the gradient of Σ sin(op) with respect to the unpadded input:
values to 1e-5, gradients to 1e-4. The port's BCSR ops (K1 and K2 on the
per-shard rect tiles, their plain versions on the CPU) are held against
JAX's edge-parallel (XLA) halo of the same math; JAX's Pallas halo runs
in interpret mode and is slow, so it is met at one tiny 120-node shape
only: ``spmm_halo_bcsr`` at D 2 (f32 at 1e-5, and bf16 at 1e-3: both
round the tiles and the operand to bf16 at the same places, the sums
differ in order), the tiled margin subset and ``affinity_halo_bcsr`` at
D 2 and 4. The ELL
op meets JAX's ELL halo in f32: JAX's halo is compiled, and XLA's
compiled CPU code keeps a bf16 table's products in f32 (ROADMAP Queue 3),
so its bf16 halo is no reference for the port's rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ggad_tpu.graph import add_self_loops as j_add_self_loops
from ggad_tpu.graph import from_scipy as j_from_scipy
from ggad_tpu.parallel import spmm_shard as js
from ggad_tpu.parallel.mesh import make_mesh as j_make_mesh
from ggad_tpu_torch.graph import add_self_loops, from_scipy
from ggad_tpu_torch.parallel import spmm_shard as ts
from ggad_tpu_torch.parallel.mesh import LocalMesh, make_mesh

N = 200
CASES = [(2, "dense"), (4, "ring"), (4, "sched")]


def weighted_graph(n, seed):
    mat = sp.random(n, n, density=0.04, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(seed))
    return sp.csr_matrix(mat + mat.T)


@functools.lru_cache(maxsize=None)
def setup(D, schedule, edge_chunks=1, n=N):
    """Both packages' partition, plan and (placed) structures of one
    graph: ``(jax dict, port dict)``."""
    mat = weighted_graph(n, seed=D)
    jg = j_add_self_loops(j_from_scipy(mat))
    tg = add_self_loops(from_scipy(mat, device="cpu"))
    jmesh, tmesh = j_make_mesh(D), make_mesh(D, device="cpu")
    jp = js.partition_edges(jg, D, edge_chunks=edge_chunks)
    tp = ts.partition_edges(tg, D, edge_chunks=edge_chunks)
    jplan, tplan = js.build_halo_plan(jp, schedule), ts.build_halo_plan(
        tp, schedule)
    rng = np.random.default_rng(D)
    idx = np.concatenate([rng.choice(n, n // 4, replace=False),
                          rng.choice(n, n // 10, replace=False)])
    seeds = rng.choice(n, n // 10, replace=False)
    j = dict(mesh=jmesh, part=js.place_partition(jp, jmesh),
             plan=js.place_halo_plan(jplan, jmesh),
             sub=js.place_halo_affinity_subset(
                 js.build_halo_affinity_subset(jp, idx), jmesh),
             seeds=js.place_halo_seed_rows(
                 js.build_halo_seed_rows(jp, seeds), jmesh),
             ells=js.place_halo_ell(js.build_halo_ell(jp, jplan), jmesh))
    t = dict(mesh=tmesh, part=ts.place_partition(tp, tmesh),
             plan=ts.place_halo_plan(tplan, tmesh),
             sub=ts.place_halo_affinity_subset(
                 ts.build_halo_affinity_subset(tp, idx), tmesh),
             sub_tiles=ts.place_halo_affinity_subset(
                 ts.build_halo_affinity_subset(tp, idx,
                                               tiles_dtype="float32"),
                 tmesh),
             seeds=ts.place_halo_seed_rows(
                 ts.build_halo_seed_rows(tp, seeds), tmesh),
             tiles=ts.place_halo_bcsr(ts.build_halo_bcsr(tp, tplan), tmesh),
             ells=ts.place_halo_ell(ts.build_halo_ell(tp, tplan), tmesh))
    return j, t


def x_input(n=N, d=12, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def run_jax(j, fn, x):
    """JAX's op and gradient, jitted: one compile, where shard_map run
    eagerly costs seconds an op on the virtual mesh."""
    part = j["part"]

    def both(h):
        out, vjp = jax.vjp(lambda h: fn(js.pad_nodes(h, part)), h)
        return out, vjp(jnp.cos(out))[0]

    out, grad = jax.jit(both)(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


def run_port(t, fn, x):
    h = torch.tensor(x, requires_grad=True)
    out = fn(ts.place_nodes(ts.pad_nodes(h, t["part"]), t["mesh"]))
    torch.sin(out).sum().backward()
    out = out.detach().numpy()
    if out.ndim == 3 or (out.ndim == 2 and out.shape[0] != x.shape[0]
                         and out.shape[1] == t["part"].rows_per_shard):
        out = out.reshape((-1,) + out.shape[2:])   # [D, R, ...] → [D·R, ...]
    return out, h.grad.numpy()


def assert_same(jax_fn, port_fn, j, t, x, tol=(1e-5, 1e-4)):
    jo, jg = run_jax(j, jax_fn, x)
    to, tg = run_port(t, port_fn, x)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, rtol=tol[0], atol=tol[0])
    np.testing.assert_allclose(tg, jg, rtol=tol[1], atol=tol[1])


@pytest.mark.parametrize("edge_chunks", [1, 3])
@pytest.mark.parametrize("D,schedule", CASES)
def test_spmm_halo_matches_jax(D, schedule, edge_chunks):
    j, t = setup(D, schedule, edge_chunks=edge_chunks)
    assert t["part"].edge_chunks == edge_chunks
    assert_same(lambda h: js.spmm_halo(j["part"], j["plan"], h, j["mesh"]),
                lambda h: ts.spmm_halo(t["part"], t["plan"], h, t["mesh"]),
                j, t, x_input())


@pytest.mark.parametrize("D,schedule", CASES)
def test_spmm_halo_bcsr_matches_jax_halo(D, schedule):
    """K1's plain version on the local and remote rect pairs, forward and
    transposed, against JAX's edge-parallel halo."""
    j, t = setup(D, schedule)
    assert_same(lambda h: js.spmm_halo(j["part"], j["plan"], h, j["mesh"]),
                lambda h: ts.spmm_halo_bcsr(t["part"], t["plan"], t["tiles"],
                                            h, t["mesh"]),
                j, t, x_input())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_halo_bcsr_matches_jax_pallas(dtype):
    """The one tiny shape against JAX's Pallas halo (interpret mode)."""
    n, D = 120, 2
    mat = weighted_graph(n, seed=9)
    jg = j_add_self_loops(j_from_scipy(mat))
    tg = add_self_loops(from_scipy(mat, device="cpu"))
    jmesh, tmesh = j_make_mesh(D), make_mesh(D, device="cpu")
    jp, tp = js.partition_edges(jg, D), ts.partition_edges(tg, D)
    jplan, tplan = js.build_halo_plan(jp), ts.build_halo_plan(tp)
    jt = js.place_halo_bcsr(js.build_halo_bcsr(jp, jplan, dtype=dtype),
                            jmesh)
    tt = ts.place_halo_bcsr(ts.build_halo_bcsr(tp, tplan, dtype=dtype),
                            tmesh)
    j = dict(part=js.place_partition(jp, jmesh))
    t = dict(part=ts.place_partition(tp, tmesh), mesh=tmesh)
    jplan, tplan = (js.place_halo_plan(jplan, jmesh),
                    ts.place_halo_plan(tplan, tmesh))
    tol = (1e-5, 1e-4) if dtype == "float32" else (1e-3, 1e-3)
    assert_same(lambda h: js.spmm_halo_bcsr(j["part"], jplan, jt, h, jmesh),
                lambda h: ts.spmm_halo_bcsr(t["part"], tplan, tt, h, tmesh),
                j, t, x_input(n, 8), tol)


@pytest.mark.parametrize("op", ["subset", "affinity_bcsr"])
@pytest.mark.parametrize("D", [2, 4])
def test_affinity_tiles_match_jax_pallas(op, D):
    """The tiled margin subset (K2, its backward two K1, both psums) and
    the tiled halo affinity (K2 on the local and remote pairs, the
    reverse exchange) against JAX's Pallas ones at the tiny shape:
    values and gradients. JAX runs them under ``check_vma=False``
    (``spmm_shard.py:817,1164``), where a ``psum``'s transpose could
    multiply the gradient by D; the port is held to the single-device
    gradient elsewhere, so this holds JAX's too."""
    n = 120
    mat = weighted_graph(n, seed=9)
    jg = j_add_self_loops(j_from_scipy(mat))
    tg = add_self_loops(from_scipy(mat, device="cpu"))
    jmesh, tmesh = j_make_mesh(D), make_mesh(D, device="cpu")
    jp, tp = js.partition_edges(jg, D), ts.partition_edges(tg, D)
    jh, th = js.build_halo_plan(jp), ts.build_halo_plan(tp)
    jplan, tplan = js.place_halo_plan(jh, jmesh), ts.place_halo_plan(th,
                                                                     tmesh)
    j = dict(part=js.place_partition(jp, jmesh))
    t = dict(part=ts.place_partition(tp, tmesh), mesh=tmesh)
    if op == "subset":
        idx = np.random.default_rng(3).choice(n, 40, replace=False)
        jsub = js.place_halo_affinity_subset(js.build_halo_affinity_subset(
            jp, idx, tiles_dtype="float32"), jmesh)
        tsub = ts.place_halo_affinity_subset(ts.build_halo_affinity_subset(
            tp, idx, tiles_dtype="float32"), tmesh)
        jfn, tfn = (lambda e: js.affinity_halo_subset(jplan, jsub, e, jmesh),
                    lambda e: ts.affinity_halo_subset(tplan, tsub, e, tmesh))
    else:
        jt = js.place_halo_bcsr(js.build_halo_bcsr(jp, jh), jmesh)
        tt = ts.place_halo_bcsr(ts.build_halo_bcsr(tp, th), tmesh)
        jfn, tfn = (
            lambda e: js.affinity_halo_bcsr(j["part"], jplan, jt, e, jmesh),
            lambda e: ts.affinity_halo_bcsr(t["part"], tplan, tt, e, tmesh))
    assert_same(jfn, tfn, j, t, x_input(n, 8))


@pytest.mark.parametrize("D,schedule", CASES)
def test_spmm_halo_ell_matches_jax(D, schedule):
    j, t = setup(D, schedule)
    assert_same(lambda h: js.spmm_halo_ell(j["part"], j["plan"], j["ells"],
                                           h, j["mesh"]),
                lambda h: ts.spmm_halo_ell(t["part"], t["plan"], t["ells"],
                                           h, t["mesh"]),
                j, t, x_input())


@pytest.mark.parametrize("D,schedule", CASES)
def test_affinity_halo_matches_jax(D, schedule):
    j, t = setup(D, schedule)
    assert_same(
        lambda e: js.affinity_halo(j["part"], j["plan"], e, j["mesh"]),
        lambda e: ts.affinity_halo(t["part"], t["plan"], e, t["mesh"]),
        j, t, x_input())


@pytest.mark.parametrize("D,schedule", CASES)
def test_affinity_halo_bcsr_matches_jax_halo(D, schedule):
    """K2's plain version on the local and remote pairs (its backward two
    K1 a pair) against JAX's edge-parallel halo affinity."""
    j, t = setup(D, schedule)
    assert_same(
        lambda e: js.affinity_halo(j["part"], j["plan"], e, j["mesh"]),
        lambda e: ts.affinity_halo_bcsr(t["part"], t["plan"], t["tiles"], e,
                                        t["mesh"]),
        j, t, x_input())


@pytest.mark.parametrize("tiles", [False, True])
@pytest.mark.parametrize("D,schedule", CASES)
def test_affinity_halo_subset_matches_jax(D, schedule, tiles):
    """Edge-parallel and on the subset's rect tiles (K2), against JAX's
    edge-parallel subset; the padding rows are zero, so the zero-norm
    guard keeps their gradient finite."""
    j, t = setup(D, schedule)
    sub = t["sub_tiles"] if tiles else t["sub"]
    assert (sub.t_fwd is not None) == tiles
    assert_same(
        lambda e: js.affinity_halo_subset(j["plan"], j["sub"], e,
                                          j["mesh"]),
        lambda e: ts.affinity_halo_subset(t["plan"], sub, e, t["mesh"]),
        j, t, x_input())


@pytest.mark.parametrize("D,schedule", CASES)
def test_spmm_halo_seed_rows_matches_jax(D, schedule):
    j, t = setup(D, schedule)
    assert_same(lambda h: js.spmm_halo_seed_rows(j["seeds"], h, j["mesh"]),
                lambda h: ts.spmm_halo_seed_rows(t["seeds"], h, t["mesh"]),
                j, t, x_input())


@pytest.mark.parametrize("D", [2, 4])
def test_all_gather_oracle_matches_jax(D):
    j, t = setup(D, "dense")
    assert_same(lambda h: js.spmm_sharded(j["part"], h, j["mesh"]),
                lambda h: ts.spmm_sharded(t["part"], h, t["mesh"]),
                j, t, x_input())
    assert_same(lambda e: js.affinity_sharded(j["part"], e, j["mesh"]),
                lambda e: ts.affinity_sharded(t["part"], e, t["mesh"]),
                j, t, x_input())


def test_node_rows_gather_and_set():
    """``gather_rows`` / ``set_rows`` over the shards equal indexing the
    unpadded array, values and gradients."""
    mesh = make_mesh(4, device="cpu")
    x = torch.tensor(x_input(50, 3), requires_grad=True)
    v = torch.randn(6, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    idx = np.array([49, 0, 13, 12, 26, 37])
    R = 13
    ni = ts.node_index(idx, R, mesh)
    xs = torch.cat([x, x.new_zeros(2, 3)]).view(4, R, 3)
    got = ts.gather_rows(mesh, xs, ni)
    put = ts.set_rows(mesh, xs, ni, v).reshape(-1, 3)[:50]
    (got.sin().sum() + put.cos().sum()).backward()
    gx, gv = x.grad.clone(), v.grad.clone()
    x.grad = v.grad = None
    t = torch.as_tensor(idx)
    torch.testing.assert_close(got, x[t])
    ref = x.index_copy(0, t, v)
    torch.testing.assert_close(put, ref)
    (x[t].sin().sum() + ref.cos().sum()).backward()
    torch.testing.assert_close(gx, x.grad)
    torch.testing.assert_close(gv, v.grad)


def test_make_mesh_comms():
    assert isinstance(make_mesh(3, device="cpu"), LocalMesh)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, comm="dist", device="cpu")
    with pytest.raises(ValueError):
        make_mesh(2, comm="nccl", device="cpu")
