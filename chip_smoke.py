#!/usr/bin/env python3
"""Drive the PyTorch port (``ggad_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout; one card

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA card of capability (9, 0) or above; print its name and
     power limit as ``nvidia-smi`` gives them;
  2. build the hand-written kernels from ``ggad_tpu_torch/csrc`` (one
     ``nvcc`` per source, all started together) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card, at the
     photo serving shapes and at a small ragged case with an empty tile
     row, in f32 and bf16; time the kernel, the plain version and one
     PyTorch library call computing the same product, and compute the
     kernel's bound from this run's shapes;
  4. serve the photo-shaped graph (``bench.py:45-49``) at n_h 300 through
     ``serve.Scorer``: 5 f32 and 5 bf16 requests from a checkpoint of the
     port's seeded init, with the kernels' launch counters set to 0 just
     before each run and read just after; the f32 scores are checked
     against a CPU run of the same weights;
  5. print the kernels' JSON line, the card line and, last,
     ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of ``ggad_tpu``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

N_H = 300
REQUESTS = 5
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,               # fp32 on the CUDA cores
              "bfloat16": 989e12}             # bf16 tensor cores, dense
TOL = {"float32": 1e-5, "bfloat16": 2e-5}     # as tests/test_torch_bcsr_spmm.py
SCORE_TOL = 1e-4                              # card f32 scores vs the CPU run
KERNEL_SOURCES = ["bcsr_spmm"]
K1_REPLACES = "ggad_tpu/ops/pallas_spmm.py:96"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels() -> None:
    from ggad_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(_build.build, KERNEL_SOURCES))
    for name, (path, log) in zip(KERNEL_SOURCES, results):
        print(f"built {name} -> {path.name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
        _build.load(name)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s")


def k1_bound_ms(tiles, n: int, d: int, dtype: str) -> tuple[float, str]:
    """Least time for the product on this run's data: the stored tiles, H
    and the output each cross device memory once, and only the non-zero
    tile entries need a multiply-add per column of H. The bound of the
    dense-tile algorithm, which multiplies the whole store, is printed
    beside it."""
    import torch

    t, tr, tc = tiles.values.shape
    nnz = int(torch.count_nonzero(tiles.values))
    h_item = 4 if dtype == "float32" else 2
    flops = 2.0 * nnz * d
    dense_flops = 2.0 * t * tr * tc * d
    nbytes = (t * tr * tc * tiles.values.element_size() + n * d * h_item
              + n * d * 4)
    by_flops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    dense_ms = max(dense_flops / PEAK_FLOPS[dtype] * 1e3, by_bytes)
    print(f"  bound inputs: T={t} tile={tr}x{tc} d={d} nnz={nnz} "
          f"useful GFLOP={flops / 1e9:.4f} dense-tile GFLOP="
          f"{dense_flops / 1e9:.2f} MB={nbytes / 1e6:.1f}; dense-tile "
          f"bound {dense_ms:.4f} ms")
    return max(by_flops, by_bytes), ("operations" if by_flops > by_bytes
                                     else "bytes")


def check_k1(tiles, h, dtype: str, *, timed: bool) -> dict:
    """Kernel vs plain version on the same card inputs."""
    import torch

    from ggad_tpu_torch.ops import bcsr_spmm as pb

    out = pb.bcsr_spmm(tiles, h)
    torch.cuda.synchronize()
    plain = pb.bcsr_spmm_plain(tiles, h)
    err = (out - plain).abs().max().item()
    torch.testing.assert_close(out, plain, rtol=TOL[dtype], atol=TOL[dtype])
    if not torch.isfinite(out).all():
        raise RuntimeError("K1 produced non-finite values")
    rec = {"max_abs_err": err}
    if not timed:
        return rec
    n, d = h.shape
    rec["ms"] = cuda_ms(lambda: pb.bcsr_spmm(tiles, h), iters=20)
    rec["plain_ms"] = cuda_ms(lambda: pb.bcsr_spmm_plain(tiles, h),
                              iters=3, warmup=1)
    rec["bound_ms"], rec["bound_by"] = k1_bound_ms(tiles, n, d, dtype)
    rec["library_ms"], lib_err = library_spmm_ms(tiles, h, dtype, out)
    print(f"  library (torch.sparse.mm, CSR) vs kernel max|d| {lib_err:.3g}")
    return rec


def library_spmm_ms(tiles, h, dtype: str, out) -> tuple[float, float]:
    """The same product in one library call: a CSR copy of the stored
    (possibly bf16-rounded) values times H rounded as the kernel rounds
    it. Timed as a yardstick; the port never calls it."""
    import torch

    tr = tiles.tile_height
    nz = tiles.values.float().nonzero(as_tuple=True)
    t, r, c = nz
    vals = tiles.values.float()[nz]
    rows = tiles.tile_rows.long()[t] * tr + r
    cols = tiles.tile_cols.long()[t] * 128 + c
    n, d = h.shape
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals, (n, n),
        check_invariants=False).coalesce().to_sparse_csr()
    hl = h if dtype == "float32" else h.to(torch.bfloat16).float()
    ref = torch.sparse.mm(csr, hl)
    err = (ref - out).abs().max().item()
    return cuda_ms(lambda: torch.sparse.mm(csr, hl), iters=20), err


def kernel_phase(cuda) -> dict:
    """Phase 3: K1 at the photo serving shapes and a small ragged case."""
    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.graph import from_coo, from_scipy
    from ggad_tpu_torch.ops import bcsr_spmm as pb
    from ggad_tpu_torch.ops.normalize import normalize_adj_reference

    gen = torch.Generator(cuda).manual_seed(0)
    results = {}
    ds = photo_bench()
    adj, _ = normalize_adj_reference(from_scipy(ds.adj, device=cuda))
    h = torch.randn(ds.n_nodes, N_H, device=cuda, generator=gen)
    for dtype in ("float32", "bfloat16"):
        bg = pb.as_bcsr_graph(adj, dtype=dtype)
        print(f"K1 photo {dtype}: T={bg.tiles.n_tiles} "
              f"tr={bg.tiles.tile_height} {bg.tiles.n_rows}x"
              f"{bg.tiles.n_cols} d={N_H}")
        rec = check_k1(bg.tiles, h, dtype, timed=True)
        print("  " + json.dumps(rec))
        results[dtype] = rec

    # ragged small case: d=40, tile row 1 (rows 128..255) has no tiles
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 300, 6000)
    rows = rows[(rows < 128) | (rows >= 256)]
    cols = rng.integers(0, 300, rows.shape[0])
    g = from_coo(rows, cols, rng.random(rows.shape[0]), 300, device=cuda)
    h_small = torch.randn(300, 40, device=cuda, generator=gen)
    for dtype in ("float32", "bfloat16"):
        tiles = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=128).tiles
        out = pb.bcsr_spmm(tiles, h_small)
        torch.cuda.synchronize()
        if not torch.all(out[128:256] == 0):
            raise RuntimeError("K1 left the empty tile row unwritten")
        rec = check_k1(tiles, h_small, dtype, timed=False)
        print(f"K1 small ragged {dtype}: max|d| {rec['max_abs_err']:.3g}")
        results[dtype]["max_abs_err"] = max(results[dtype]["max_abs_err"],
                                            rec["max_abs_err"])
    return results


def stage_breakdown(scorer) -> dict:
    """CUDA-event times of the eval forward's stages (median of 10)."""
    import torch

    from ggad_tpu_torch.ops.spmm import spmm

    tr = scorer.trainer
    m = tr.model
    stages = {}
    with torch.no_grad():
        h1 = m.gcn1(tr.adj, tr.features, pre_agg=tr.ax)
        hw = m.gcn2.fc(h1)
        emb = m.gcn2(tr.adj, h1)
        for name, fn in [
                ("gcn1 (dense, on hoisted Ax)",
                 lambda: m.gcn1(tr.adj, tr.features, pre_agg=tr.ax)),
                ("gcn2 fc", lambda: m.gcn2.fc(h1)),
                ("gcn2 spmm (K1)", lambda: spmm(tr.adj, hw)),
                ("head", lambda: m.head(emb))]:
            stages[name] = statistics.median(
                cuda_ms(fn, iters=1, warmup=0) for _ in range(10))
    return stages


def serving_phase(cuda, k1: dict) -> None:
    """Phase 4: Scorer requests at full width, launches counted."""
    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.models.ggad import GGAD
    from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm
    from ggad_tpu_torch.serve import Scorer
    from ggad_tpu_torch.train.checkpoint import Checkpointer

    ds = photo_bench()
    print(f"serving graph: nodes={ds.n_nodes} edges={ds.n_edges} "
          f"feats={ds.feat_dim} n_h={N_H}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        init = GGAD(ds.feat_dim, N_H,
                    generator=torch.Generator().manual_seed(0))
        Checkpointer(ckpt_dir).save(0, {"params": init.state_dict(),
                                        "epoch": 0})
        scores = {}
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            scorer = Scorer(ckpt_dir, ds, embedding_dim=N_H,
                            spmm_dtype=dtype, device=cuda)
            torch.cuda.synchronize()
            prep = time.perf_counter() - t0
            if not isinstance(scorer.trainer.adj, BCSRGraph):
                raise RuntimeError("the photo graph did not route to BCSR")
            lat = []
            bcsr_spmm.launches = 0
            for _ in range(REQUESTS):
                t0 = time.perf_counter()
                res = scorer.score()
                lat.append((time.perf_counter() - t0) * 1e3)
            launches = bcsr_spmm.launches
            fwd = []
            for _ in range(REQUESTS):
                t0 = time.perf_counter()
                scorer.trainer.eval_scores(scorer.params)
                fwd.append((time.perf_counter() - t0) * 1e3)
            if launches != REQUESTS:
                raise RuntimeError(f"{dtype}: {launches} K1 launches for "
                                   f"{REQUESTS} requests")
            if (res.scores.shape != (ds.n_nodes,)
                    or not np.all(np.isfinite(res.scores))):
                raise RuntimeError(f"{dtype}: bad scores")
            k1[dtype]["launches"] = launches
            scores[dtype] = res
            print(f"serve {dtype}: prepare {prep:.3f} s; request ms "
                  f"{[round(x, 3) for x in lat]} (median "
                  f"{statistics.median(lat):.3f}); eval_scores alone "
                  f"(forward + copy to host) median "
                  f"{statistics.median(fwd):.3f} ms; AUROC {res.auc:.6f} "
                  f"AP {res.ap:.6f}; K1 launches {launches}")
            print(f"  eval forward by stage (ms, CUDA events): "
                  f"{json.dumps(stage_breakdown(scorer))}")

        cpu = Scorer(ckpt_dir, ds, embedding_dim=N_H, device="cpu").score()
    diff = np.abs(scores["float32"].scores - cpu.scores).max()
    np.testing.assert_allclose(scores["float32"].scores, cpu.scores,
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    bf_diff = np.abs(scores["bfloat16"].scores - cpu.scores).max()
    print(f"f32 card vs CPU max|d| {diff:.3g} (tol {SCORE_TOL}); "
          f"AUROC card {scores['float32'].auc:.6f} cpu {cpu.auc:.6f}; "
          f"bf16 card vs CPU f32 max|d| {bf_diff:.3g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.get_device_capability(0) < (9, 0):
        print("chip_smoke: needs compute capability 9.0 (sm_90a)",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # true f32 plain version
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    t_start = time.perf_counter()

    build_kernels()
    k1 = kernel_phase(cuda)
    serving_phase(cuda, k1)

    kernels = []
    for dtype, rec in k1.items():
        kernels.append({
            "name": f"bcsr_spmm_{'f32' if dtype == 'float32' else 'bf16'}",
            "route": "cuda", "source": "ggad_tpu_torch/csrc/bcsr_spmm.cu",
            "replaces": K1_REPLACES, "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
