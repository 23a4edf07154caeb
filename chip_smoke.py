#!/usr/bin/env python3
"""Drive the PyTorch port (``ggad_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout; one card

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA card of capability (9, 0) or above; print its name and
     power limit as ``nvidia-smi`` gives them;
  2. build the hand-written kernels from ``ggad_tpu_torch/csrc`` (one
     ``nvcc`` per source, all started together) and print the build time;
  3. serve the photo-shaped graph (``bench.py:45-49``) at n_h 300 through
     ``serve.Scorer``: 5 f32 and 5 bf16 requests from a checkpoint of the
     port's seeded init, with the kernels' launch counters set to 0 just
     before each run and read just after; the preparation's time and the
     device memory it holds (no training-only structure is built); the f32
     scores are checked against a CPU run of the same weights;
  4. train on the same graph at n_h 300 through ``FullBatchTrainer.train``:
     10 f32 and 10 bf16 epochs from the port's seeded init, counters set to
     0 just before and read just after (2 K1 a step in f32; 4 K1 + 1 K2 in
     bf16; 1 K1 per evaluation); finite losses; the time and device
     memory of the preparation and of its training-only part
     (``prepare_training``); the step time (CUDA events,
     median of 10) and a breakdown by stage; 3 f32 steps with
     ``noise_std=0`` on the card against the same steps on the CPU;
  5. hold each kernel against its plain PyTorch version on the card, in f32
     and bf16: K1 at the photo serving shapes, on the transposed tile set
     and on the rectangular sets of the labeled-column subset, at the tile
     heights 128, 256, 512 and 1024 (the sweep of
     ``scripts/tile_rows_study.py``, whose kernel is K1's body), and at a
     small ragged case with an empty tile row; K2 at the photo ``[U × N]``
     subset shapes of the bf16 trainer and at a small ragged square case
     with an empty tile row. Time each kernel (device time from
     ``torch.profiler``), its plain version and one PyTorch library call
     computing the same function, and compute each kernel's bound from this
     run's non-zeros (with the bound of the CSR walk the kernels implement
     beside it, and the bytes the walk gathers through L2);
  6. profile a request and a train step of each precision: the device
     time against the wall time (the card's busy share) and the largest
     kernels; and the step's kernels alone. The profiler runs only after
     the timed phases 3 and 4, since it adds to the host's launch time;
  7. print the kernels' JSON line, the card line and, last,
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
from functools import partial

N_H = 300
REQUESTS = 5
EPOCHS = 10                                   # train() epochs per precision
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,               # fp32 on the CUDA cores
              "bfloat16": 989e12}             # bf16 tensor cores, dense
TOL = {"float32": 1e-5, "bfloat16": 2e-5}     # tests/test_torch_bcsr_spmm.py
K2_TOL = {"float32": 1e-5, "bfloat16": 1e-4}  # as tests/test_torch_gpu.py
SCORE_TOL = 1e-4                              # card f32 scores vs the CPU run
LOSS_TOL = 1e-4                               # card f32 losses vs the CPU run
KERNEL_SOURCES = ["bcsr_spmm", "bcsr_sddmm"]
K1_REPLACES = "ggad_tpu/ops/pallas_spmm.py:96"
STUDY_REPLACES = "scripts/tile_rows_study.py:52"   # K1's body, swept
SWEEP_TILE_ROWS = (128, 256, 512, 1024)    # tile_rows_study.py:105 + 1024
K2_REPLACES = "ggad_tpu/ops/pallas_sddmm.py:41"
SHORT = {"float32": "f32", "bfloat16": "bf16"}


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


def device_ms(fn, iters: int = 20) -> tuple[float, dict]:
    """Mean device milliseconds per call: the summed time of every kernel
    the call puts on the card (``torch.profiler``, CUPTI), free of host
    launch overhead; and the microseconds per call of each kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / iters
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total
           and not e.is_user_annotation}
    if not per:
        raise RuntimeError("the profiler saw no kernel on the card")
    return sum(per.values()) / 1e3, per


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


def bound_ms(tiles, n_rows: int, dense_bytes: int, design_bytes: int,
             d: int, dtype: str, what: str) -> dict:
    """Least time for a tile kernel's function on this run's data, the
    larger of its bytes at the memory rate and its operations at the peak
    rate of the type. The function needs the non-zeros in CSR (a value and
    a 4-byte column index each, a 4-byte pointer per row), the dense
    operands and the output once (``dense_bytes``), and 2·d operations per
    non-zero.

    Beside it, ``design_bound_ms``, the bound of the CSR walk the kernel
    implements: the same operations, and the bytes it moves through device
    memory, the CSR and ``design_bytes`` (the operands as the caller gives
    them, the copies the wrapper makes for the kernel written and read,
    the output). The walk also gathers one operand row per non-zero,
    nnz·d·item bytes (``gather_mb``), which L2 serves, since the gathered
    operand fits in it; no published L2 rate bounds those, so the rate the
    kernel reaches on them is reported instead (``gather_tb_s``)."""
    import torch

    t, tr, tc = tiles.values.shape
    item = tiles.values.element_size()
    nnz = tiles.col.numel()
    if nnz != int(torch.count_nonzero(tiles.values)):
        raise RuntimeError("the CSR does not hold the store's non-zeros")
    sparse_bytes = nnz * (item + 4) + (n_rows + 1) * 4
    peak = PEAK_FLOPS[dtype] / 1e3
    by_flops = 2.0 * d * nnz / peak
    by_bytes = (sparse_bytes + dense_bytes) / HBM_BYTES_PER_S * 1e3
    design = max(by_flops, (sparse_bytes + design_bytes)
                 / HBM_BYTES_PER_S * 1e3)
    gather = nnz * d * item
    print(f"  {what} bound inputs: T={t} tile={tr}x{tc} nnz={nnz} "
          f"useful GFLOP={2 * d * nnz / 1e9:.4f} MB: CSR non-zeros "
          f"{sparse_bytes / 1e6:.2f} + dense operands and output "
          f"{dense_bytes / 1e6:.2f} (CSR walk: {design_bytes / 1e6:.2f}, "
          f"bound {design:.5f} ms); gathered through L2 "
          f"{gather / 1e6:.1f} MB")
    return {"bound_ms": max(by_flops, by_bytes),
            "bound_by": "operations" if by_flops > by_bytes else "bytes",
            "design_bound_ms": design, "gather_mb": gather / 1e6}


def k1_bound_ms(tiles, n: int, d: int, dtype: str) -> dict:
    """K1: A's non-zeros, H (rounded to the tiles' type) and the f32
    output each cross device memory once; a multiply-add per non-zero
    and column of H. The CSR walk reads H in f32 and, for bf16 tiles,
    writes and reads its bf16 copy."""
    copy = 0 if dtype == "float32" else 2 * n * d * 2
    return bound_ms(tiles, n, n * d * (4 if dtype == "float32" else 2)
                    + n * d * 4, n * d * 4 + copy + n * d * 4, d, dtype,
                    "K1")


def k2_bound_ms(tiles, e_row, e_col, dtype: str) -> dict:
    """K2: M's non-zeros, E_r, E_c (rounded to the tiles' type) and the
    f32 output each cross device memory once; one dot product of length
    d per non-zero (its multiply by M and the row sum are lower order).
    The CSR walk reads E_r, E_c in f32 and, for bf16 tiles, writes and
    reads their bf16 copies."""
    item = 4 if dtype == "float32" else 2
    n_r, d = e_row.shape
    rows = n_r + e_col.shape[0]
    copy = 0 if dtype == "float32" else 2 * rows * d * 2
    return bound_ms(tiles, n_r, rows * d * item + n_r * 4,
                    rows * d * 4 + copy + n_r * 4, d, dtype, "K2")


def check_k1(tiles, h, dtype: str, *, n_out=None, timed: bool) -> dict:
    """Kernel vs plain version on the same card inputs."""
    import torch

    from ggad_tpu_torch.ops import bcsr_spmm as pb

    out = pb.bcsr_matmul(tiles, h, n_out)
    torch.cuda.synchronize()
    plain = pb.bcsr_spmm_plain(tiles, h, n_out)
    err = (out - plain).abs().max().item()
    torch.testing.assert_close(out, plain, rtol=TOL[dtype], atol=TOL[dtype])
    if not torch.isfinite(out).all():
        raise RuntimeError("K1 produced non-finite values")
    rec = {"max_abs_err": err}
    if not timed:
        return rec
    n, d = h.shape
    rec["ms"], per = device_ms(lambda: pb.bcsr_matmul(tiles, h))
    rec["call_ms"] = cuda_ms(lambda: pb.bcsr_matmul(tiles, h), iters=20)
    rec["plain_ms"] = cuda_ms(lambda: pb.bcsr_spmm_plain(tiles, h),
                              iters=3, warmup=1)
    rec.update(k1_bound_ms(tiles, n, d, dtype))
    rec["gather_tb_s"] = rec["gather_mb"] / rec["ms"] / 1e6
    rec["library_ms"], lib_err = library_spmm_ms(tiles, h, dtype, out)
    print(f"  device us per call by kernel: {json.dumps(per)}")
    print(f"  library (torch.sparse.mm, CSR) vs kernel max|d| {lib_err:.3g}")
    return rec


def tile_coo(tiles):
    """(rows, cols, values) of the stored non-zeros, values in f32."""
    tr = tiles.tile_height
    v = tiles.values.float()
    t, r, c = v.nonzero(as_tuple=True)
    return (tiles.tile_rows.long()[t] * tr + r,
            tiles.tile_cols.long()[t] * 128 + c, v[t, r, c])


def library_spmm_ms(tiles, h, dtype: str, out) -> tuple[float, float]:
    """The same product in one library call: a CSR copy of the stored
    (possibly bf16-rounded) values times H rounded as the kernel rounds
    it. Timed as a yardstick; the port never calls it."""
    import torch

    rows, cols, vals = tile_coo(tiles)
    n, d = h.shape
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals, (n, n),
        check_invariants=False).coalesce().to_sparse_csr()
    hl = h if dtype == "float32" else h.to(torch.bfloat16).float()
    ref = torch.sparse.mm(csr, hl)
    err = (ref - out).abs().max().item()
    return device_ms(lambda: torch.sparse.mm(csr, hl))[0], err


def library_sddmm_ms(tiles, e_row, e_col, dtype: str, out
                     ) -> tuple[float, float]:
    """K2's function through the library: ``torch.sparse.sampled_addmm``
    of E_r and E_cᵀ on a CSR copy of M's pattern, times M's values, row
    sums, in f32. For bf16 tiles the stored values are already bf16 and
    E_r, E_c are rounded to bf16 and back, as the kernel rounds them, so
    every product is the kernel's exact one. Returns (ms, max |d| against
    the kernel). Timed as a yardstick; the port never calls it."""
    import torch

    rows, cols, vals = tile_coo(tiles)
    n_r, n_c = e_row.shape[0], e_col.shape[0]
    keep = (rows < n_r) & (cols < n_c)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals, (n_r, n_c),
        check_invariants=False).coalesce().to_sparse_csr()
    crow = csr.crow_indices()
    row_of = torch.repeat_interleave(
        torch.arange(n_r, device=crow.device), crow[1:] - crow[:-1])
    er, ect = e_row, e_col.t()
    if dtype == "bfloat16":
        er = er.to(torch.bfloat16).float()
        ect = ect.to(torch.bfloat16).float()

    def call():
        dots = torch.sparse.sampled_addmm(csr, er, ect, beta=0.0)
        return torch.zeros(n_r, device=er.device).index_add_(
            0, row_of, dots.values() * csr.values())

    err = (call() - out[:n_r]).abs().max().item()
    return device_ms(call)[0], err


def check_k2(tiles, e_row, e_col, dtype: str, *, timed: bool) -> dict:
    """K2 vs its plain version on the same card inputs."""
    import torch

    from ggad_tpu_torch.ops import bcsr_sddmm as pk2

    out = pk2.sddmm_colsum(tiles, e_row, e_col)
    torch.cuda.synchronize()
    plain = pk2.bcsr_sddmm_colsum_plain(tiles, e_row, e_col)
    err = (out - plain).abs().max().item()
    torch.testing.assert_close(out, plain, rtol=K2_TOL[dtype],
                               atol=K2_TOL[dtype])
    if not torch.isfinite(out).all():
        raise RuntimeError("K2 produced non-finite values")
    rec = {"max_abs_err": err}
    if not timed:
        return rec
    rec["ms"], per = device_ms(
        lambda: pk2.sddmm_colsum(tiles, e_row, e_col))
    rec["call_ms"] = cuda_ms(lambda: pk2.sddmm_colsum(tiles, e_row, e_col),
                             iters=20)
    rec["plain_ms"] = cuda_ms(
        lambda: pk2.bcsr_sddmm_colsum_plain(tiles, e_row, e_col), iters=3,
        warmup=1)
    rec.update(k2_bound_ms(tiles, e_row, e_col, dtype))
    rec["gather_tb_s"] = rec["gather_mb"] / rec["ms"] / 1e6
    print(f"  device us per call by kernel: {json.dumps(per)}")
    rec["library_ms"], lib = library_sddmm_ms(tiles, e_row, e_col, dtype,
                                              out)
    print(f"  library (sampled_addmm + row sum, f32) vs kernel max|d| "
          f"{lib:.3g}")
    return rec


def small_ragged_graph(cuda):
    """300 nodes; no edge in rows 128..255, so tile row 1 is empty."""
    import numpy as np

    from ggad_tpu_torch.graph import from_coo

    rng = np.random.default_rng(1)
    rows = rng.integers(0, 300, 6000)
    rows = rows[(rows < 128) | (rows >= 256)]
    cols = rng.integers(0, 300, rows.shape[0])
    return from_coo(rows, cols, rng.random(rows.shape[0]), 300, device=cuda)


def labeled(ds):
    import numpy as np

    return np.concatenate([np.asarray(ds.normal_label_idx, np.int64),
                           np.asarray(ds.abnormal_label_idx, np.int64)])


def tile_rows_sweep(adj, h, dtype: str) -> list:
    """K1 on the photo forward tiles at each height of the study's sweep,
    held against its plain version; prints what the study printed
    (``tile_rows_study.py:188-195``), the kernel's time from the card."""
    from ggad_tpu_torch.ops import bcsr_spmm as pb

    rows = []
    for tr in SWEEP_TILE_ROWS:
        tiles = pb.as_bcsr_graph(adj, dtype=dtype, tile_rows=tr,
                                 transpose=False).tiles.fwd
        err = check_k1(tiles, h, dtype, timed=False)["max_abs_err"]
        ms, _ = device_ms(lambda: pb.bcsr_matmul(tiles, h))
        v = tiles.values
        rows.append({"tile_rows": tr, "n_tiles": tiles.n_tiles,
                     "tile_store_MB": round(v.numel() * v.element_size()
                                            / 2 ** 20, 1),
                     "spmm_ms": ms,
                     "edges_per_tile": round(adj.n_edges / tiles.n_tiles, 1),
                     "max_abs_err": err})
        print(f"  K1 tile-height sweep {dtype}: {json.dumps(rows[-1])}")
        del tiles, v
    return rows


def kernel_phase(cuda, k1: dict, k2: dict) -> None:
    """Phase 5: K1 and K2 at the photo shapes and at small ragged cases;
    adds each kernel's record to ``k1``/``k2`` (by dtype)."""
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.graph import from_scipy
    from ggad_tpu_torch.ops import bcsr_spmm as pb
    from ggad_tpu_torch.ops.bcsr_sddmm import sddmm_colsum
    from ggad_tpu_torch.ops.normalize import normalize_adj_reference
    from ggad_tpu_torch.ops.sddmm import (
        l2_normalize_rows,
        tile_affinity_subset,
    )

    gen = torch.Generator(cuda).manual_seed(0)
    ds = photo_bench()
    adj, raw = normalize_adj_reference(from_scipy(ds.adj, device=cuda))
    h = torch.randn(ds.n_nodes, N_H, device=cuda, generator=gen)
    emb_n = l2_normalize_rows(torch.randn(ds.n_nodes, N_H, device=cuda,
                                          generator=gen))
    for dtype in ("float32", "bfloat16"):
        pair = pb.as_bcsr_graph(adj, dtype=dtype).tiles
        fwd = pair.fwd
        print(f"K1 photo {dtype}: T={fwd.n_tiles} tr={fwd.tile_height} "
              f"{fwd.n_rows}x{fwd.n_cols} d={N_H}")
        k1[dtype].update(check_k1(fwd, h, dtype, timed=True))
        print("  " + json.dumps(k1[dtype]))
        errs = [check_k1(pair.bwd, h, dtype, timed=False)["max_abs_err"]]
        sub = tile_affinity_subset(raw, labeled(ds), dtype=dtype)
        u = sub.n_uniq
        hu = torch.randn(u, N_H, device=cuda, generator=gen)
        errs.append(check_k1(sub.pair.bwd, h, dtype, n_out=u,
                             timed=False)["max_abs_err"])
        errs.append(check_k1(sub.pair.fwd, hu, dtype, n_out=ds.n_nodes,
                             timed=False)["max_abs_err"])
        print(f"K1 photo {dtype} transposed / rect [U x N] / rect [N x U] "
              f"(U={u}): max|d| {errs}")
        k1[dtype]["max_abs_err"] = max([k1[dtype]["max_abs_err"], *errs])
        k1[dtype]["tile_rows_sweep"] = tile_rows_sweep(adj, h, dtype)
        k1[dtype]["max_abs_err"] = max(
            k1[dtype]["max_abs_err"],
            *(r["max_abs_err"] for r in k1[dtype]["tile_rows_sweep"]))

        b = sub.pair.bwd
        print(f"K2 photo {dtype} [U x N]: T={b.n_tiles} tr={b.tile_height} "
              f"{b.n_rows}x{b.n_cols} U={u} d={N_H}")
        tgt = emb_n[sub.uniq].contiguous()
        k2[dtype].update(check_k2(b, tgt, emb_n, dtype, timed=True))
        print("  " + json.dumps(k2[dtype]))

    g = small_ragged_graph(cuda)
    h_small = torch.randn(300, 40, device=cuda, generator=gen)
    e_small = l2_normalize_rows(torch.randn(300, 33, device=cuda,
                                            generator=gen))
    for dtype in ("float32", "bfloat16"):
        pair = pb.as_bcsr_graph(g, dtype=dtype, tile_rows=128).tiles
        out = pb.bcsr_matmul(pair.fwd, h_small)
        out2 = sddmm_colsum(pair.fwd, e_small, e_small)
        torch.cuda.synchronize()
        if not (torch.all(out[128:256] == 0)
                and torch.all(out2[128:256] == 0)):
            raise RuntimeError("a kernel left the empty tile row unwritten")
        e1 = check_k1(pair.fwd, h_small, dtype, timed=False)["max_abs_err"]
        e2 = check_k2(pair.fwd, e_small, e_small, dtype,
                      timed=False)["max_abs_err"]
        print(f"small ragged {dtype}: K1 max|d| {e1:.3g}, K2 max|d| "
              f"{e2:.3g}")
        k1[dtype]["max_abs_err"] = max(k1[dtype]["max_abs_err"], e1)
        k2[dtype]["max_abs_err"] = max(k2[dtype]["max_abs_err"], e2)


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


def serving_phase(cuda, k1: dict, later: list) -> None:
    """Phase 3: Scorer requests at full width, launches counted; appends
    to ``later`` the profiled lines, printed after the timed phases."""
    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.models.ggad import GGAD
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
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
        scores, scorers = {}, {}
        for dtype in ("float32", "bfloat16"):
            scorer = None
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            scorer = Scorer(ckpt_dir, ds, embedding_dim=N_H,
                            spmm_dtype=dtype, device=cuda)
            torch.cuda.synchronize()
            prep = time.perf_counter() - t0
            held = (torch.cuda.memory_allocated() - base) / 1e6
            if not isinstance(scorer.trainer.adj, BCSRGraph):
                raise RuntimeError("the photo graph did not route to BCSR")
            if (scorer.trainer.adj.tiles.bwd is not None
                    or scorer.trainer.aff_sub is not None):
                raise RuntimeError("serving built training-only structures")
            lat = []
            bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
            for _ in range(REQUESTS):
                t0 = time.perf_counter()
                res = scorer.score()
                lat.append((time.perf_counter() - t0) * 1e3)
            launches = bcsr_spmm.launches
            if bcsr_sddmm_colsum.launches:
                raise RuntimeError("serving launched K2")
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
            k1[dtype]["paths"] = {"serve": launches}
            scores[dtype] = res
            print(f"serve {dtype}: prepare {prep:.3f} s, device memory "
                  f"held {held:.1f} MB; request ms "
                  f"{[round(x, 3) for x in lat]} (median "
                  f"{statistics.median(lat):.3f}); eval_scores alone "
                  f"(forward + copy to host) median "
                  f"{statistics.median(fwd):.3f} ms; AUROC {res.auc:.6f} "
                  f"AP {res.ap:.6f}; K1 launches {launches}")
            print(f"  eval forward by stage (ms, CUDA events): "
                  f"{json.dumps(stage_breakdown(scorer))}")
            scorers[dtype] = (scorer, statistics.median(lat))

        cpu = Scorer(ckpt_dir, ds, embedding_dim=N_H, device="cpu").score()
        later.extend(partial(busy_line, f"serve request {dtype}", sc.score,
                             wall, REQUESTS)
                     for dtype, (sc, wall) in scorers.items())
    diff = np.abs(scores["float32"].scores - cpu.scores).max()
    np.testing.assert_allclose(scores["float32"].scores, cpu.scores,
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    bf_diff = np.abs(scores["bfloat16"].scores - cpu.scores).max()
    print(f"f32 card vs CPU max|d| {diff:.3g} (tol {SCORE_TOL}); "
          f"AUROC card {scores['float32'].auc:.6f} cpu {cpu.auc:.6f}; "
          f"bf16 card vs CPU f32 max|d| {bf_diff:.3g}")


def train_stages(tr, gen, reps: int = 5) -> dict:
    """CUDA-event times of one train step by stage (median of ``reps``
    steps)."""
    import torch

    from ggad_tpu_torch.train.losses import ggad_losses

    names = ["forward", "loss", "backward", "adam"]
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        tr.optimizer.zero_grad(set_to_none=True)
        noise = tr.draw_noise(gen)
        ev[0].record()
        out = tr.model(tr.adj, tr.features, tr.seed_idx, tr.normal_idx,
                       train=True, seed_adj=tr.seed_adj, ax=tr.ax,
                       noise=noise)
        ev[1].record()
        losses = ggad_losses(out, tr.raw_adj, tr.seed_idx, tr.normal_idx,
                             confidence_margin=tr.confidence_margin,
                             pos_weight=tr.pos_weight, aff_sub=tr.aff_sub)
        ev[2].record()
        losses.total.backward()
        ev[3].record()
        tr.optimizer.step()
        ev[4].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    return {n: statistics.median(r[i] for r in rows)
            for i, n in enumerate(names)}


def step_kernels_line(dtype: str, tr, gen) -> str:
    """Device time of the train step's kernels alone at its shapes
    (``device_ms``, mean of 10 calls)."""
    import torch

    from ggad_tpu_torch.ops import bcsr_spmm as pb
    from ggad_tpu_torch.ops.bcsr_sddmm import sddmm_colsum
    from ggad_tpu_torch.ops.sddmm import TileAffinitySubset, l2_normalize_rows

    stages = {}
    n = tr.dataset.n_nodes
    pair = tr.adj.tiles
    h = torch.randn(n, N_H, device=tr.device, generator=gen)
    stages["K1 forward (gcn2, tiles)"] = device_ms(
        lambda: pb.bcsr_matmul(pair.fwd, h), iters=10)[0]
    stages["K1 backward (transposed tiles)"] = device_ms(
        lambda: pb.bcsr_matmul(pair.bwd, h), iters=10)[0]
    if isinstance(tr.aff_sub, TileAffinitySubset):
        sub = tr.aff_sub
        e = l2_normalize_rows(h)
        tgt = e[sub.uniq].contiguous()
        g = torch.randn(sub.n_uniq, N_H, device=tr.device, generator=gen)
        stages["K2 (margin affinity, [U x N])"] = device_ms(
            lambda: sddmm_colsum(sub.pair.bwd, tgt, e), iters=10)[0]
        stages["K2's two K1 (rect sets)"] = device_ms(
            lambda: (pb.bcsr_matmul(sub.pair.bwd, e, sub.n_uniq),
                     pb.bcsr_matmul(sub.pair.fwd, g, n)), iters=10)[0]
    return (f"  train {dtype} kernels alone at the step's shapes (ms, "
            f"device): {json.dumps(stages)}")


def busy_line(what: str, fn, wall_ms: float, iters: int) -> str:
    """The device time of ``iters`` calls of ``fn`` (``device_ms``) against
    their median wall time: the card's busy share, and its largest
    kernels."""
    dev, per = device_ms(fn, iters=iters)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return (f"  {what}: device time {dev:.4f} ms a call against a median of "
            f"{wall_ms:.3f} ms, busy share {dev / wall_ms:.3f}; largest "
            f"kernels (us a call) "
            f"{json.dumps({k[:60]: round(v, 2) for k, v in top})}")


def training_phase(cuda, k1: dict, k2: dict, later: list) -> None:
    """Phase 4: ``FullBatchTrainer.train`` at full width, launches counted
    exactly; step time and stages; f32 card losses against the CPU;
    appends to ``later`` the profiled lines, printed after the timed
    phases."""
    import math

    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm
    from ggad_tpu_torch.ops.sddmm import AffinitySubset, TileAffinitySubset
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    ds = photo_bench()
    per_step = {"float32": (2, 0), "bfloat16": (4, 1)}    # (K1, K2)
    n_evals = sum(1 for e in range(EPOCHS)
                  if e % EPOCHS == 0 or e == EPOCHS - 1) + 1
    for dtype in ("float32", "bfloat16"):
        tr = None
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = FullBatchTrainer(ds, embedding_dim=N_H, spmm_dtype=dtype,
                              num_epoch=EPOCHS, eval_every=EPOCHS,
                              log_every=1, noise_mean=0.02, noise_std=0.01,
                              device=cuda)
        torch.cuda.synchronize()
        served = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        tr.prepare_training()
        torch.cuda.synchronize()
        prep, prep_train = t1 - t0, time.perf_counter() - t1
        mem = ((served - base) / 1e6,
               (torch.cuda.memory_allocated() - served) / 1e6)
        want_sub = (TileAffinitySubset if dtype == "bfloat16"
                    else AffinitySubset)
        if not (isinstance(tr.adj, BCSRGraph)
                and isinstance(tr.aff_sub, want_sub)):
            raise RuntimeError(f"{dtype}: the photo graph took another "
                               f"route ({type(tr.adj).__name__}, "
                               f"{type(tr.aff_sub).__name__})")
        bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
        t0 = time.perf_counter()
        res = tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
        want = (EPOCHS * per_step[dtype][0] + n_evals,
                EPOCHS * per_step[dtype][1])
        if (n1, n2) != want:
            raise RuntimeError(f"{dtype}: train() launched K1 {n1} and K2 "
                               f"{n2} times; expected {want}")
        losses = [r["loss"] for r in res.history if "loss" in r]
        if len(losses) != EPOCHS or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"{dtype}: bad losses {losses}")
        k1[dtype]["paths"]["train"] = n1
        k2[dtype]["paths"] = {"train": n2}

        gen = torch.Generator(cuda).manual_seed(1)
        bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(EPOCHS + 1)]
        ev[0].record()
        for i in range(EPOCHS):
            tr.train_step(gen)
            ev[i + 1].record()
        torch.cuda.synchronize()
        steps = [ev[i].elapsed_time(ev[i + 1]) for i in range(EPOCHS)]
        if (bcsr_spmm.launches, bcsr_sddmm_colsum.launches) != (
                EPOCHS * per_step[dtype][0], EPOCHS * per_step[dtype][1]):
            raise RuntimeError(f"{dtype}: train_step launch counts")
        print(f"train {dtype}: prepare {prep:.3f} s + training-only "
              f"{prep_train:.3f} s; device memory {mem[0]:.1f} MB + "
              f"training-only {mem[1]:.1f} MB; train() {EPOCHS} "
              f"epochs + {n_evals} evaluations {wall:.3f} s; K1 launches "
              f"{n1}, K2 launches {n2}; losses {[round(x, 6) for x in losses]}"
              f"; final AUROC {res.final_auc:.6f} AP {res.final_ap:.6f}")
        print(f"  step ms (CUDA events) {[round(x, 3) for x in steps]} "
              f"(median {statistics.median(steps):.3f})")
        print(f"  step by stage (ms, CUDA events): "
              f"{json.dumps(train_stages(tr, gen))}")
        later.append(partial(busy_line, f"train step {dtype}",
                             partial(tr.train_step, gen),
                             statistics.median(steps), EPOCHS))
        later.append(partial(step_kernels_line, dtype, tr, gen))

    # 3 f32 steps, noise_std=0, the same init on the card and on the CPU
    card_cpu = {}
    for device in (cuda, "cpu"):
        tr = FullBatchTrainer(ds, embedding_dim=N_H, noise_mean=0.02,
                              noise_std=0.0, device=device)
        tr.model.load_state_dict(tr.init())
        gen = torch.Generator(tr.device).manual_seed(0)
        card_cpu[str(device)] = [[float(x) for x in tr.train_step(gen)]
                                 for _ in range(3)]
    card, cpu = card_cpu[str(cuda)], card_cpu["cpu"]
    diff = max(abs(a - b) for sa, sb in zip(card, cpu)
               for a, b in zip(sa, sb))
    for sa, sb in zip(card, cpu):
        for a, b in zip(sa, sb):
            if not abs(a - b) <= LOSS_TOL * (1 + abs(b)):
                raise RuntimeError(f"card losses {card} vs CPU {cpu}")
    print(f"train f32 card vs CPU, 3 steps, six loss fields: max|d| "
          f"{diff:.3g} (tol {LOSS_TOL}); totals card "
          f"{[round(s[0], 6) for s in card]} cpu "
          f"{[round(s[0], 6) for s in cpu]}")


def kernel_record(name, source, replaces, rec) -> dict:
    paths = rec.get("paths", {})
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": sum(paths.values()),
           "launches_by_path": paths, "max_abs_err": rec["max_abs_err"],
           "ms": rec["ms"], "call_ms": rec["call_ms"],
           "plain_ms": rec["plain_ms"],
           "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
           "design_bound_ms": rec["design_bound_ms"],
           "gather_mb": rec["gather_mb"], "gather_tb_s": rec["gather_tb_s"],
           "library_ms": rec["library_ms"]}
    if "tile_rows_sweep" in rec:
        out["also_replaces"] = [STUDY_REPLACES]
        out["tile_rows_sweep"] = {r["tile_rows"]: r["spmm_ms"]
                                  for r in rec["tile_rows_sweep"]}
    return out


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
    # the end-to-end phases first: they are timed with CUDA events and the
    # host clock, before any profiler session adds its launch overhead
    k1 = {"float32": {}, "bfloat16": {}}
    k2 = {"float32": {}, "bfloat16": {}}
    later = []
    serving_phase(cuda, k1, later)
    training_phase(cuda, k1, k2, later)
    kernel_phase(cuda, k1, k2)
    for line in later:
        print(line())

    kernels = [kernel_record(f"bcsr_spmm_{SHORT[dtype]}",
                             "ggad_tpu_torch/csrc/bcsr_spmm.cu", K1_REPLACES,
                             rec) for dtype, rec in k1.items()]
    kernels += [kernel_record(f"bcsr_sddmm_{SHORT[dtype]}",
                              "ggad_tpu_torch/csrc/bcsr_sddmm.cu",
                              K2_REPLACES, rec) for dtype, rec in k2.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
