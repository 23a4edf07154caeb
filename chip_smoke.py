#!/usr/bin/env python3
"""Drive the PyTorch port (``ggad_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout; one card

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA card of capability (9, 0) or above; print its name and
     power limit as ``nvidia-smi`` gives them;
  2. build the hand-written kernels from ``ggad_tpu_torch/csrc`` (one
     ``nvcc`` per source) and the host graph builder
     (``csrc/graphbuild.cpp``, ``g++``), all started together, and print
     the build times; ``native.available()`` must hold (a compiler is
     present here, so a Python route would be a failure);
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
  5. the sparse regime: the elliptic-shaped graph (``bench.py:208-209``,
     46,564 nodes) at n_h 300 under ``spmm_impl="auto"``, which must give
     the ELL sigma tables (plain PyTorch, no hand-written kernel: K1's and
     K2's counters are set to 0 at the start and must read 0 at the end);
     the tables' buckets and build time; 5 f32 + 5 bf16 Scorer requests
     (f32 scores against a CPU run), 10 + 10 ``train()`` epochs, step
     times and stages, prepare time and memory, 3 f32 steps against the
     CPU;
  6. the minibatch (DGraph) path: the full-size DGraph-shaped graph
     (``load_dataset("dgraphfin")``'s synthetic fallback, 3,700,550 nodes,
     17 features) through ``MiniBatchTrainer`` at emb 64, fanouts 16/8,
     batch 150 + 50, 150 batches an epoch: the host build timed by part
     (load, ``adj + I``, split, the trainer's preparation), the host
     library's entry points it called (the load's ``symmetrize`` and
     ``build_indptr`` must run; ``NeighborTable.from_scipy`` reaches no
     sort), the same load on the Python route (scipy; the adjacency must
     be equal) and the device
     memory the table and features hold; ``train()`` for 2 epochs with
     validation at the first and the last and the test metrics; the step
     median (CUDA events), one epoch's wall time, ``score_nodes`` over the
     validation split in nodes/s with the host metrics apart; 3 steps and
     4,096 scores on the card against the CPU from the same weights,
     batches and draws (ids equal, losses and scores within 1e-4). Plain
     PyTorch: K1 and K2 must launch 0 times in the phase;
 6b. the minibatch baselines on phase 6's graph, ``adj + I`` and split
     (plain PyTorch, K1 = K2 = 0 in the phase): GraphSAGE, PC-GNN (three
     relations sharing one table), DOMINANT-mb, AnomalyDAE-mb and AEGIS-mb
     at emb 64, batch 150 (+ 50 anomalies for the classifiers), 50
     batches an epoch, through their runs' ``train()`` for 2 epochs: the
     final AUROC/AP (best validation AUROC for the classifiers), the step
     median (CUDA events), one epoch's wall, ``idx_test`` scoring in
     nodes/s with the host metrics apart, held and peak device memory; 3
     steps and 4,096 scores of each on the card against the CPU from the
     same weights, batch ids (equal), draws and noise table (within
     1e-4·(1 + |CPU|)); PC-GNN on three relations of their own
     (``synthetic_gad(n_relations=3)``, 20,000 nodes), 2 steps against the
     CPU; the exact set-union replay (symmetrized, no self-loops): 10
     batches of 150 + 50 at one pad shape (U_pad, E_pad, the bytes of
     ``mask2``), ``Adam(1e-3, weight_decay=0.007)``, each batch's host
     build time and card step (CUDA events), the losses and 4,096
     validation scores in 150-node slices against the CPU; ``rwr_subgraphs``
     (4,096 seeds, size 4, walk 12) and ``pick_step`` (4,096 ids), card
     equal to the CPU from the same draws;
  6c. data-parallel minibatch GGAD on phase 6's graph (before it is
     freed): ``MiniBatchTrainer(mesh=4)`` on the local communicator at
     phase 6's width (batch 150 + 50, 50 ids a shard, eval_batch 1024)
     beside the single-device trainer: the device memory each holds (the
     tables once: within 10%), 3 steps from the same weights, batches and
     draws (losses within 1e-4·(1 + |ref|)) and 4,096 scores (within
     1e-5·(1 + |ref|)), step medians side by side (CUDA events), one
     epoch cut to 20 batches, the peak memory of the steps; K1 = K2 = 0;
     then the ``"dist"`` communicator on NCCL at world size 1 against the
     local one at D 1 for 2 steps;
 7. the full-batch baseline zoo on the photo-shaped graph at n_h 300
     (GAAN at its fixed noise 16 and hid 64): DOMINANT, AnomalyDAE,
     OCGNN, GAAN and AEGIS in both modes through their runners
     (``train.baselines.run_*``) for 5 epochs (AEGIS after 3 pretrain
     epochs), K1's counter set to 0 before each and read after (OCGNN 4 a
     step and 2 an evaluation, AEGIS 10 a pretrain and 12 an adversarial
     step, the others 0; K2 0), finite losses, final AUROC/AP; each
     model's step median (CUDA events), peak and held device memory; 2
     steps (AEGIS: a pretrain and an adversarial one) on the card against
     the CPU (its COO route) from the same weights and noise, losses and
     scores within 1e-4; then OCGNN on the elliptic-shaped graph through
     ``run_baseline`` under ``auto`` for 3 epochs, which must take the ELL
     route with K1 = K2 = 0;
  8. TAM on the photo-shaped graph at n_h 300 (8 members, cutting 8,
     n_tree 1, lr 1e-5, seed 0, TAM's split) through ``run_tam_baseline``
     for the reference's 500 epochs under ``auto``, which must take the
     block-diagonal route: K1's counter set to 0 before and read after (4
     launches an epoch a member chunk, K2 0), the per-round and final
     AUROC/AP; the same ensemble built again: the block-diagonal tile
     pair's host build time and device memory, the epoch median (CUDA
     events) and peak memory; the same cut values and weights through the
     card's BCSR and ELL routes for 3 epochs (messages and scores within
     1e-4·(1 + |ELL|)) and, for 2 members and 2 epochs, the card's BCSR
     against the CPU's ELL (per-member losses, messages and scores within
     1e-4·(1 + |CPU|)); then 3 epochs on the elliptic-shaped graph under
     ``auto``, which must take the ELL route with K1 = K2 = 0;
 8b. the halo path (the multi-device slice) on the photo shape at n_h 300:
     ``FullBatchTrainer(mesh=4)`` on the local communicator (4 shards on
     the one card) for the dense, ring and sched wires in f32 and the
     dense one in bf16, each ``prepare`` + 5 steps + an evaluation from
     one init and one noise sequence, K1's and K2's counters set to 0
     before each and read after (per shard: 2 K1 for the hoisted Â·x, 6
     K1 and 1 K2 a step, 2 K1 an evaluation; K2 in f32 too); f32 losses
     and scores within 1e-4·(1 + |ref|) of the single-device trainer, the
     wires within 1e-5·(1 + |dense|) of each other, bf16 losses within
     1e-3·(1 + |f32|) of f32 (the scores' difference printed), f32 and
     bf16 each 2 steps + an evaluation within 1e-4·(1 + |CPU|) of the
     same halo on the CPU (the plain versions); the photo shape
     renumbered by ``reorder_lp`` (a boundary below the shard's rows) on
     the sched wire in f32, 5 steps + an evaluation with exact counts
     against the single-device trainer, its cut and the three wires'
     widths printed; the plan's widths, wire rows
     and bytes, each shard's tile counts, prepare time, held memory and
     the step median beside the single-device step; every shard's rect
     sets held against their plain versions at the path's widths (K1
     forward at 745 and 300, transposed at 300, the margin subset's K2
     and its two K1; after phase 9), shard 0's timed against the bound,
     the plain version and ``torch.sparse.mm`` (``sampled_addmm``); the elliptic
     shape at D 4 on the ELL route (3 steps + an evaluation against the
     single-device trainer, K1 = K2 = 0); the ``"dist"`` communicator on
     NCCL at world size 1 (a ``TCPStore`` on localhost) against the local
     one at D 1 for 2 steps, with exact counts. NCCL at D > 1 needs more
     than one card;
  8c. the rest of the multi-device slice on the photo shape at n_h 300:
     ``FullBatchTrainer(mesh=4, dist_impl="gspmd")`` (the all-gather
     layout, K1 = K2 = 0), 5 steps + an evaluation against the
     single-device trainer on the COO route from the same weights and
     noise (the 5 steps' losses and the scores at the reference's weights
     within 1e-4·(1 + |ref|); the scores after each side's own 1 and 5
     steps, and the single-device BCSR-vs-COO spread after 5, printed as
     readings), its step median
     beside the single-device COO and BCSR steps, prepare time, held and
     peak memory; 2 steps of 2-D tensor parallelism on a (2, 2)
     ``('nodes', 'model')`` mesh against the 1-D GSPMD step at D 4 (losses
     within 1e-4 relative), both timed; ``entry.entry()``'s forward,
     finite; ``entry.dryrun_multichip(4)`` with all its assertions, its
     halo BCSR leg launching exactly 4 × (2 + 6) K1 and 4 K2 and every
     other leg none; the CLI's ``--model ggad-minibatch --dp_devices 4``
     and ``--mesh_devices 4 --dist_impl gspmd`` on the card, their last
     JSON lines parsed;
 8d. the halo path on the full Amazon shape (``synthetic_like("Amazon")``:
     11,944 nodes, ≈4.4M entries, 25 features) at n_h 300, f32: the
     elliptic shape's ``multilevel_partition`` at D 4 on the native route
     and on the Python route (labels equal, both times printed);
     ``reorder_lp(ds, 4)`` on the native route (its time, the host
     library's calls, the cut fraction); ``FullBatchTrainer(mesh=4)`` on
     the local communicator, BCSR, sched wire: prepare + 3 steps + an
     evaluation with exact K1/K2 counts, losses and scores within
     1e-4·(1 + |ref|) of the single-device trainer from the same init and
     noise, the step median beside the single-device one (CUDA events),
     prepare time, held and peak memory, the plan's widths and shard 0's
     rect tile counts; after phase 9 every shard's rect K1 at d 300 held
     against its plain version, shard 0's timed against its bound, the
     plain version and ``torch.sparse.mm`` (the kernels line's
     ``amazon_halo_rect``);
 8e. ``profile_dir``: photo f32 ``FullBatchTrainer.train()`` for 6 epochs
     (an evaluation every 3) with ``profile_dir`` set; its Chrome trace
     (epochs 2 to 4) is parsed: K1's kernel events, found by the kernel's
     symbol, must equal the launch counter read over the same window (2 a
     step and 1 for epoch 3's evaluation), and K2 has none;
 9. hold each kernel against its plain PyTorch version on the card, in f32
     and bf16: K1 at the photo serving shapes, on the transposed tile set
     and on the rectangular sets of the labeled-column subset, at the tile
     heights 128, 256, 512 and 1024 (the sweep of
     ``scripts/tile_rows_study.py``, whose kernel is K1's body), and at a
     small ragged case with an empty tile row; K2 at the photo ``[U × N]``
     subset shapes of the bf16 trainer and at a small ragged square case
     with an empty tile row. Time each kernel (device time from
     ``torch.profiler``), its plain version and one PyTorch library call
     computing the same function (K1 also at d 745, AEGIS
     ``gcn_dec2``'s width), and compute each kernel's bound from this
     run's non-zeros (with the bound of the CSR walk the kernels implement
     beside it, and the bytes the walk gathers through L2); K1 f32 also on
     TAM's block-diagonal tile pair, forward and transposed, at d 600 and
     300 (gcn1's and gcn2's widths), timed against its bound, its plain
     version and ``torch.sparse.mm``;
 10. profile a request and a train step of each precision, photo and
     ELL, a minibatch step, a step of each minibatch baseline and a step
     of each baseline of the zoo, a halo step of each wire and
     precision (photo, D 4) and of the elliptic shape, the DP minibatch
     step, the GSPMD step and the 2-D step: the device time
     against the wall time (the card's busy share), the device operations
     a call and the largest kernels; the photo step's kernels alone and the ELL step's table
     products alone; a TAM epoch and its parts (K1, the einsums, the ELL
     affinities) alone; the Amazon halo step (8d). The profiler runs only
     after the timed phases 3 to 8d, since it adds to the host's launch
     time (8e's trace comes after them too);
 11. print the kernels' JSON line, the card line and, last,
     ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of ``ggad_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
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
SMEM_BYTES_PER_S = 128 * 132 * 1.98e9         # 128 B a clock, 132 SMs, boost
PEAK_FLOPS = {"float32": 67e12,               # fp32 on the CUDA cores
              "bfloat16": 989e12}             # bf16 tensor cores, dense
TOL = {"float32": 1e-5, "bfloat16": 2e-5}     # tests/test_torch_bcsr_spmm.py
K2_TOL = {"float32": 1e-5, "bfloat16": 1e-4}  # as tests/test_torch_gpu.py
SCORE_TOL = 1e-4                              # card f32 scores vs the CPU run
LOSS_TOL = 1e-4                               # card f32 losses vs the CPU run
MB_EPOCHS = 2                                 # minibatch train() epochs
MB_STEPS = 20                                 # timed minibatch steps
MB_CPU_STEPS = 3                              # minibatch steps vs the CPU
MB_CPU_SCORES = 4096                          # minibatch scores vs the CPU
# the minibatch baselines (phase 6b): the five runners at full width,
# epochs cut from the reference's 30; batch 150 (+ 50 anomalies for the
# classifiers), 50 batches an epoch, as baselines.py:625-872
MBB_MODELS = ("sage", "pcgnn", "dominant-minibatch", "anomalydae-minibatch",
              "aegis-minibatch")
MBB_EPOCHS = 2
MBB_CPU_STEPS = 3                             # steps vs the CPU a model
MBB_REL_STEPS = 2                             # PC-GNN, 3 relations, vs CPU
EXACT_BATCHES = 10                            # exact replay batches
EXACT_SCORES = 4096                           # exact eval nodes, 150 a slice
MASK2_LIMIT = 8e9                             # bytes of f32 mask2 allowed
RWR_SEEDS, RWR_SIZE, RWR_WALK = 4096, 4, 12
KERNEL_SOURCES = ["bcsr_spmm", "bcsr_sddmm"]
HOST_SOURCE = "graphbuild"                    # csrc/graphbuild.cpp, g++
K1_REPLACES = "ggad_tpu/ops/pallas_spmm.py:96"
STUDY_REPLACES = "scripts/tile_rows_study.py:52"   # K1's body, swept
SWEEP_TILE_ROWS = (128, 256, 512, 1024)    # tile_rows_study.py:105 + 1024
K2_REPLACES = "ggad_tpu/ops/pallas_sddmm.py:41"
ZOO = [("dominant", None), ("anomalydae", None), ("ocgnn", None),
       ("gaan", None), ("aegis", False), ("aegis", True)]
ZOO_EPOCHS = 5                                # adversarial epochs for AEGIS
ZOO_EVAL_EVERY = 10                           # the CLI's --eval_every
ZOO_PRETRAIN = 3                              # AEGIS pretrain epochs
ZOO_STEPS = 10                                # timed steps a model
ZOO_CPU_STEPS = 2                             # zoo steps vs the CPU
# K1 launches from the autograd graph: OCGNN's two GCN layers forward and
# backward, its evaluation forward; AEGIS's six GCN forwards, backward
# through the real path only in pretraining, through all six when loss_g
# reaches the generated path. DOMINANT, AnomalyDAE and GAAN launch none.
ZOO_K1 = {"ocgnn": {"step": 4, "eval": 2},
          "aegis": {"pretrain": 10, "step": 12}}
D_DEC2 = 745                                  # AEGIS gcn_dec2 width (photo F)
TAM_EPOCHS = 500                              # tam.py hardcodes 500
TAM_CUTTING = 8
TAM_LR = 1e-5
TAM_K1 = 4              # K1 an epoch a chunk: gcn1, gcn2 forward + backward
TAM_TIMED = 10                                # timed ensemble epochs
TAM_ROUTE_EPOCHS = 3                          # card BCSR vs card ELL
TAM_CPU_MEMBERS, TAM_CPU_EPOCHS = 2, 2        # card BCSR vs CPU ELL
TAM_ELL_EPOCHS = 3                            # elliptic-shaped TAM
# the halo path (phase 8b): D shards of the photo shape on the card
HALO_D = 4
HALO_RUNS = (("dense", "float32"), ("ring", "float32"), ("sched", "float32"),
             ("dense", "bfloat16"))
HALO_STEPS = 5                                # steps a run, then one eval
HALO_CPU_STEPS = 2                            # halo steps on the CPU
HALO_ELL_STEPS = 3                            # elliptic-shaped halo steps
HALO_NCCL_STEPS = 2                           # the "dist" mesh at D = 1
HALO_LP_SCHEDULE = "sched"                    # the reorder_lp run's wire
# K1 a shard: 2 for the hoisted Â·x (local + remote pair), 6 a step (gcn2
# forward and backward on both pairs, the margin subset's backward), 2 an
# evaluation; K2 a shard: 1 a step (the margin subset)
HALO_K1 = {"prepare": 2, "step": 6, "eval": 2}
HALO_K2_STEP = 1
WIRE_TOL = 1e-5                               # the wires against each other
BF16_TOL = 1e-3                               # bf16 vs f32 losses (the tests')
# bf16 halo scores, card vs CPU at the same weights: bf16's unit roundoff.
# The f32 inputs of a bf16 rounding differ in their last bits between the
# card's and the CPU's dense products, so a few of gcn2's bf16 operands
# round the other way, and each moves its neighbours' scores by up to
# 2^-8·Â (a low-degree node's Â is near 1/2); a path in the wrong dtype
# is off by the bf16-vs-f32 gap, several times this
BF16_SCORE_TOL = 2.0 ** -8
DP_D = 4                                      # data-parallel shards
DP_STEPS = 20                                 # timed DP steps
DP_CHECK_STEPS = 3                            # DP vs single-device steps
DP_SCORES = 4096                              # DP vs single-device scores
DP_SCORE_TOL = 1e-5
DP_EPOCH_BATCHES = 20                         # the DP epoch, cut from 150
DP_NCCL_STEPS = 2                             # the "dist" mesh at D = 1
NCCL_TOL = 1e-6                               # NCCL D1 vs local D1
GSPMD_D = 4
GSPMD_STEPS = 5                               # steps a run, then one eval
TP_SHAPE = (2, 2)                             # ('nodes', 'model')
TP_STEPS = 2
TP_TOL = 1e-4                                 # tests/test_parallel.py:614
DRYRUN_D = 4
# phase 8d: the halo path on the full Amazon shape after reorder_lp
AMAZON_D = 4
AMAZON_STEPS = 3                              # steps, then one evaluation
AMAZON_SCHEDULE = "sched"
# phase 8e: profile_dir over train(); epochs 2..4 traced, epoch 3 evaluated
PROFILE_EPOCHS = 6
PROFILE_EVAL_EVERY = 3
K1_SYMBOL, K2_SYMBOL = "csr_spmm_kernel", "csr_sddmm_kernel"
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


def device_ms(fn, iters: int = 20) -> tuple[float, dict, float]:
    """Mean device milliseconds per call: the summed time of every kernel
    the call puts on the card (``torch.profiler``, CUPTI), free of host
    launch overhead; the microseconds per call of each kernel; and the
    device operations (kernels, copies, fills) per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a session now and then returns no device activity, or only part of
    # it (seen once in a dozen runs each: no kernel, or 3 of 20 calls'
    # kernels); every call launches at least one operation on the card, so
    # a session that saw fewer than one a call is taken again, at most
    # twice
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total and not e.is_user_annotation]
        seen = sum(e.count for e in events)
        if seen >= iters:
            break
        print(f"  profiler session {attempt + 1} saw {seen} device "
              f"operations in {iters} calls")
    else:
        raise RuntimeError("the profiler missed the card's operations")
    per = {e.key: e.self_device_time_total / iters for e in events}
    return (sum(per.values()) / 1e3, per,
            sum(e.count for e in events) / iters)


def event_ms(fn, iters: int = 20) -> float:
    """Median device milliseconds of one call: CUDA events around each of
    ``iters`` calls, all enqueued behind a sleep on the card so that the
    host's launch time stays out of the intervals (no profiler)."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)          # ≈50 ms of the card's clock
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def build_kernels() -> None:
    """The kernels' ``nvcc`` builds and the host library's ``g++`` build,
    all started together."""
    from ggad_tpu_torch import native
    from ggad_tpu_torch.ops import _build

    def host_build():
        t = time.perf_counter()
        path, _ = _build.build_host(HOST_SOURCE)
        return path, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        host = pool.submit(host_build)
        results = list(pool.map(_build.build, KERNEL_SOURCES))
        host_path, host_s = host.result()
    for name, (path, log) in zip(KERNEL_SOURCES, results):
        print(f"built {name} -> {path.name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
        _build.load(name)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s")
    if not native.available():
        raise RuntimeError("no C++ compiler: the host library would take "
                           "its Python routes")
    native.load()
    print(f"built {HOST_SOURCE} -> {host_path.name} with "
          f"{_build.cxx_path()} in {host_s:.3f} s (host library, "
          f"native.available() {native.available()})")


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


def k1_bound_ms(tiles, n: int, d: int, dtype: str,
                n_out: int | None = None) -> dict:
    """K1: A's non-zeros, H (``[n, d]``, rounded to the tiles' type) and
    the f32 output (``n_out`` rows, default n) each cross device memory
    once; a multiply-add per non-zero and column of H. The CSR walk reads
    H in f32 and, for bf16 tiles, writes and reads its bf16 copy."""
    m = n if n_out is None else n_out
    copy = 0 if dtype == "float32" else 2 * n * d * 2
    return bound_ms(tiles, m, n * d * (4 if dtype == "float32" else 2)
                    + m * d * 4, n * d * 4 + copy + m * d * 4, d, dtype,
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
    """Kernel vs plain version on the same card inputs: the store's own
    route (``bcsr_matmul``) and the other route (the walk or the staged
    route, forced); timed, also both routes' device times and the staged
    launch's shape (blocks, shared memory a block, stages, slab MB)."""
    import torch

    from ggad_tpu_torch.ops import bcsr_spmm as pb

    m = h.shape[0] if n_out is None else n_out
    out = pb.bcsr_matmul(tiles, h, n_out)
    view = pb.tile_view(tiles) if tiles.view is None else tiles.view
    other = pb.bcsr_spmm_cuda(tiles, h, m,
                              view=None if tiles.view is not None else view)
    torch.cuda.synchronize()
    plain = pb.bcsr_spmm_plain(tiles, h, n_out)
    err = max((out - plain).abs().max().item(),
              (other - plain).abs().max().item())
    for got in (out, other):
        torch.testing.assert_close(got, plain, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        if not torch.isfinite(got).all():
            raise RuntimeError("K1 produced non-finite values")
    rec = {"max_abs_err": err, "k1_route": tiles.route}
    if not timed:
        return rec
    n, d = h.shape
    rec["ms"], per, _ = device_ms(lambda: pb.bcsr_matmul(tiles, h, n_out))
    rec["call_ms"] = cuda_ms(lambda: pb.bcsr_matmul(tiles, h, n_out),
                             iters=20)
    rec["plain_ms"] = cuda_ms(lambda: pb.bcsr_spmm_plain(tiles, h, n_out),
                              iters=3, warmup=1)
    for route, v in (("walk", None), ("staged", view)):
        rec[f"{route}_ms"] = event_ms(
            lambda: pb.bcsr_spmm_cuda(tiles, h, m, view=v))
    shape = pb.k1_launch_shape(tiles, d, m, view)
    rec.update({k: shape[k] for k in ("blocks", "smem_bytes", "stages",
                                      "slab_mb", "reuse")})
    rec.update(k1_bound_ms(tiles, n, d, dtype, n_out))
    # the staged route's own bound: its shared-memory reads, a slab row
    # of 64 columns and an 8-byte entry per non-zero and chunk
    nnz, item = tiles.col.numel(), tiles.values.element_size()
    chunks = -(-d // pb.STAGED_CHUNK)
    smem = nnz * chunks * (pb.STAGED_CHUNK * item + 8)
    rec["staged_smem_mb"] = smem / 1e6
    rec["staged_bound_ms"] = max(
        2.0 * d * nnz / (PEAK_FLOPS[dtype] / 1e3),
        smem / SMEM_BYTES_PER_S * 1e3)
    rec["gather_tb_s"] = rec["gather_mb"] / rec["ms"] / 1e3
    rec["library_ms"], lib_err = library_spmm_ms(tiles, h, dtype, out,
                                                 n_out)
    print(f"  device us per call by kernel: {json.dumps(per)}")
    print(f"  K1 route {tiles.route} (slab reuse {shape['reuse']:.2f}): "
          f"walk {rec['walk_ms']:.4f} ms, staged {rec['staged_ms']:.4f} ms "
          f"({shape['blocks']} blocks of {shape['threads']} threads, "
          f"{shape['smem_bytes']} B shared a block, {shape['stages']} "
          f"stages, slab {shape['slab_mb']:.1f} MB against the walk's "
          f"gather {rec['gather_mb']:.1f} MB)")
    print(f"  library (torch.sparse.mm, CSR) vs kernel max|d| {lib_err:.3g}")
    return rec


def walk_pace(tiles, x, n_out: int) -> dict:
    """What sets the walk's pace on a store: its rows' non-zero counts
    (mean, 99th percentile, most) and the walk's device time (CUDA events)
    with every row cut to its first k non-zeros, for k from 16 up to the
    longest row (the store itself), each beside the non-zeros kept; on the
    whole store, at one column chunk (d 128) against the full width; and
    the same non-zeros with every row cut into pieces of at most 64, each
    piece a row of its own. A warp walks one (row, chunk) alone, so a time
    that follows the longest row while the non-zeros barely move, and
    falls when the same non-zeros are cut into short rows, is set by the
    longest rows' chains."""
    import dataclasses

    import torch

    from ggad_tpu_torch.ops import bcsr_spmm as pb

    v, tr = tiles.values, tiles.tile_height
    t, r, c = torch.nonzero(v, as_tuple=True)
    grow, order = torch.sort(tiles.tile_rows.long()[t] * tr + r, stable=True)
    t, r, c = t[order], r[order], c[order]        # tile_csr's order
    rank = torch.arange(grow.numel(), device=v.device) \
        - tiles.row_ptr.long()[grow]
    per_row = (tiles.row_ptr[1:] - tiles.row_ptr[:-1])[:n_out].float()
    most = int(per_row.max())
    stats = {"mean": round(float(per_row.mean()), 2),
             "p99": float(torch.quantile(per_row, 0.99)), "max": most}
    walk = lambda s, h: pb.bcsr_spmm_cuda(s, h, n_out, view=None)  # noqa
    by_cap = {}
    for k in [k for k in (16, 32, 64, 128, 256, 512) if k < most] + [most]:
        cut = v.clone()
        drop = rank >= k
        cut[t[drop], r[drop], c[drop]] = 0
        capped = dataclasses.replace(tiles, values=cut)
        by_cap[k] = {"nnz": capped.col.numel(),
                     "walk_ms": event_ms(lambda: walk(capped, x))}
        del capped, cut
    narrow = x[:, :128].contiguous()
    # pieces 1, 2, ... of each row on rows of their own, after n_out
    piece = rank // 64
    cut = piece > 0
    key, inv = torch.unique(grow[cut] * (most // 64 + 1) + piece[cut],
                            return_inverse=True)
    row = grow.clone()
    row[cut] = n_out + inv
    n_split = n_out + key.numel()
    split = pb.bcsr_rect_from_coo(
        row.cpu().numpy(), tiles.col.cpu().numpy(),
        tiles.val.float().cpu().numpy(), n_split, tiles.n_cols,
        dtype=v.dtype, tile_rows=tr, device=v.device)
    out = {"row_nnz": stats, "walk_ms_by_row_cap": by_cap,
           "walk_ms_d128": event_ms(lambda: walk(tiles, narrow)),
           "rows_cut_at_64": {
               "rows": n_split, "nnz": split.col.numel(),
               "walk_ms": event_ms(lambda: pb.bcsr_spmm_cuda(
                   split, x, n_split, view=None))}}
    print(f"  walk pace: rows' non-zeros {json.dumps(stats)}; walk ms by "
          f"row cap {json.dumps(by_cap)}; at d 128 "
          f"{out['walk_ms_d128']:.4f} ms (d {x.shape[1]}: "
          f"{by_cap[most]['walk_ms']:.4f}); rows cut into pieces of 64 "
          f"{json.dumps(out['rows_cut_at_64'])}")
    return out


# what a timed K2 shape keeps in the kernels line
K2_KEEP = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
           "design_bound_ms", "library_ms", "max_abs_err")
# what a timed K1 shape keeps in the kernels line
K1_KEEP = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
           "design_bound_ms", "library_ms", "max_abs_err", "k1_route",
           "walk_ms", "staged_ms", "gather_mb", "gather_tb_s", "slab_mb",
           "smem_bytes", "blocks", "stages", "reuse", "staged_smem_mb",
           "staged_bound_ms")


def tile_coo(tiles):
    """(rows, cols, values) of the stored non-zeros, values in f32."""
    tr = tiles.tile_height
    v = tiles.values.float()
    t, r, c = v.nonzero(as_tuple=True)
    return (tiles.tile_rows.long()[t] * tr + r,
            tiles.tile_cols.long()[t] * 128 + c, v[t, r, c])


def library_spmm_ms(tiles, h, dtype: str, out,
                    n_out: int | None = None) -> tuple[float, float]:
    """The same product in one library call: a CSR copy of the stored
    (possibly bf16-rounded) values, ``[n_out × n]`` (default square),
    times H rounded as the kernel rounds it. Timed as a yardstick; the
    port never calls it."""
    import torch

    rows, cols, vals = tile_coo(tiles)
    n, d = h.shape
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals, (n if n_out is None else n_out, n),
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
    rec["ms"], per, _ = device_ms(
        lambda: pk2.sddmm_colsum(tiles, e_row, e_col))
    rec["call_ms"] = cuda_ms(lambda: pk2.sddmm_colsum(tiles, e_row, e_col),
                             iters=20)
    rec["plain_ms"] = cuda_ms(
        lambda: pk2.bcsr_sddmm_colsum_plain(tiles, e_row, e_col), iters=3,
        warmup=1)
    rec.update(k2_bound_ms(tiles, e_row, e_col, dtype))
    rec["gather_tb_s"] = rec["gather_mb"] / rec["ms"] / 1e3
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
    both routes held against the plain version; prints what the study
    printed (``tile_rows_study.py:188-195``), the kernel's time from the
    card, and both routes' times with the staged slab's reuse and bytes
    (the height sets how many non-zeros a staged slab row serves)."""
    from ggad_tpu_torch.ops import bcsr_spmm as pb

    rows = []
    for tr in SWEEP_TILE_ROWS:
        tiles = pb.as_bcsr_graph(adj, dtype=dtype, tile_rows=tr,
                                 transpose=False).tiles.fwd
        err = check_k1(tiles, h, dtype, timed=False)["max_abs_err"]
        ms = device_ms(lambda: pb.bcsr_matmul(tiles, h))[0]
        view = pb.tile_view(tiles) if tiles.view is None else tiles.view
        n = h.shape[0]
        shape = pb.k1_launch_shape(tiles, h.shape[1], n, view)
        v = tiles.values
        rows.append({"tile_rows": tr, "n_tiles": tiles.n_tiles,
                     "tile_store_MB": round(v.numel() * v.element_size()
                                            / 2 ** 20, 1),
                     "spmm_ms": ms, "k1_route": tiles.route,
                     "walk_ms": event_ms(lambda: pb.bcsr_spmm_cuda(
                         tiles, h, n, view=None)),
                     "staged_ms": event_ms(lambda: pb.bcsr_spmm_cuda(
                         tiles, h, n, view=view)),
                     "slab_reuse": round(shape["reuse"], 3),
                     "slab_mb": round(shape["slab_mb"], 1),
                     "edges_per_tile": round(adj.n_edges / tiles.n_tiles, 1),
                     "max_abs_err": err})
        print(f"  K1 tile-height sweep {dtype}: {json.dumps(rows[-1])}")
        del tiles, v, view
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
        h_dec = torch.randn(ds.n_nodes, D_DEC2, device=cuda, generator=gen)
        print(f"K1 photo {dtype} at d={D_DEC2} (AEGIS gcn_dec2's width; "
              f"its operand copied to a whole-vector stride)")
        dec = check_k1(fwd, h_dec, dtype, timed=True)
        k1[dtype]["at_d745"] = {key: dec[key] for key in K1_KEEP}
        print("  " + json.dumps(k1[dtype]["at_d745"]))
        k1[dtype]["max_abs_err"] = max(k1[dtype]["max_abs_err"],
                                       dec["max_abs_err"])
        del h_dec
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

    from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph
    from ggad_tpu_torch.ops.spmm import spmm

    tr = scorer.trainer
    m = tr.model
    spmm_stage = ("gcn2 spmm (K1)" if isinstance(tr.adj, BCSRGraph)
                  else "gcn2 spmm (ELL sigma tables)")
    stages = {}
    with torch.no_grad():
        h1 = m.gcn1(tr.adj, tr.features, pre_agg=tr.ax)
        hw = m.gcn2.fc(h1)
        emb = m.gcn2(tr.adj, h1)
        for name, fn in [
                ("gcn1 (dense, on hoisted Ax)",
                 lambda: m.gcn1(tr.adj, tr.features, pre_agg=tr.ax)),
                ("gcn2 fc", lambda: m.gcn2.fc(h1)),
                (spmm_stage, lambda: spmm(tr.adj, hw)),
                ("head", lambda: m.head(emb))]:
            stages[name] = statistics.median(
                cuda_ms(fn, iters=1, warmup=0) for _ in range(10))
    return stages


def save_seeded_init(ckpt_dir: str, ds) -> None:
    """A checkpoint of the port's seeded init (seed 0) at n_h ``N_H``."""
    import torch

    from ggad_tpu_torch.models.ggad import GGAD
    from ggad_tpu_torch.train.checkpoint import Checkpointer

    init = GGAD(ds.feat_dim, N_H, generator=torch.Generator().manual_seed(0))
    Checkpointer(ckpt_dir).save(0, {"params": init.state_dict(), "epoch": 0})


def serving_phase(cuda, k1: dict, later: list) -> None:
    """Phase 3: Scorer requests at full width, launches counted; appends
    to ``later`` the profiled lines, printed after the timed phases."""
    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph, bcsr_spmm
    from ggad_tpu_torch.serve import Scorer

    ds = photo_bench()
    print(f"serving graph: nodes={ds.n_nodes} edges={ds.n_edges} "
          f"feats={ds.feat_dim} n_h={N_H}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        save_seeded_init(ckpt_dir, ds)
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


def ell_sweeps_line(dtype: str, tr, gen) -> str:
    """Device time of the ELL route's table products alone at the step's
    shapes (``device_ms``, mean of 10 calls): how much of the step the
    bucket sweeps take."""
    import torch

    from ggad_tpu_torch.ops import ell_spmm as pe
    from ggad_tpu_torch.ops.sddmm import l2_normalize_rows

    n, s = tr.dataset.n_nodes, tr.seed_idx.shape[0]
    sub, seed, pair = tr.aff_sub, tr.seed_adj.tables, tr.adj.tables
    h = torch.randn(n, N_H, device=tr.device, generator=gen)
    hs = torch.randn(s, N_H, device=tr.device, generator=gen)
    hu = torch.randn(sub.n_uniq, N_H, device=tr.device, generator=gen)
    e = l2_normalize_rows(h)
    tgt = e[sub.uniq.long()]
    stages = {name: device_ms(fn, iters=10)[0] for name, fn in [
        ("gcn2 forward [N x N]", lambda: pe._matmul_any(pair.fwd, h)),
        ("gcn2 backward (transposed)", lambda: pe._matmul_any(pair.bwd, h)),
        ("seed aggregation [S x N]", lambda: pe._matmul_any(seed.fwd, h)),
        ("seed backward [N x S]", lambda: pe._matmul_any(seed.bwd, hs)),
        ("margin colsum [U x N]",
         lambda: pe._colsum_any(sub.bwd, e, tgt)),
        ("margin backward [N x U] + [U x N]",
         lambda: (pe._matmul_any(sub.fwd, hu), pe._matmul_any(sub.bwd, e)))]}
    stages["sum"] = sum(stages.values())
    return (f"  ELL train {dtype} table products alone at the step's shapes "
            f"(ms, device): {json.dumps(stages)}")

def busy_line(what: str, fn, wall_ms: float, iters: int) -> str:
    """The device time of ``iters`` calls of ``fn`` (``device_ms``) against
    their median wall time: the card's busy share, and its largest
    kernels."""
    dev, per, ops = device_ms(fn, iters=iters)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return (f"  {what}: device time {dev:.4f} ms a call against a median of "
            f"{wall_ms:.3f} ms, busy share {dev / wall_ms:.3f}; {ops:.1f} "
            f"device ops a call; largest kernels (us a call) "
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

    card_vs_cpu_steps(ds, cuda, "train")


def card_vs_cpu_steps(ds, cuda, what: str) -> None:
    """3 f32 steps with ``noise_std=0`` from the same init on the card and
    on the CPU (``spmm_impl="auto"``): all six loss fields within
    ``LOSS_TOL``."""
    import torch

    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

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
                raise RuntimeError(f"{what}: card losses {card} vs CPU {cpu}")
    print(f"{what} f32 card vs CPU, 3 steps, six loss fields: max|d| "
          f"{diff:.3g} (tol {LOSS_TOL}); totals card "
          f"{[round(s[0], 6) for s in card]} cpu "
          f"{[round(s[0], 6) for s in cpu]}")


def ell_tables_line(what: str, t, build_s=None) -> str:
    """A sigma table's buckets (K, rows), slots, zero rows, residual and,
    when given, its build time."""
    buckets = [(b.idx.shape[0], b.idx.shape[1]) for b in t.buckets]
    line = (f"  {what}: buckets (K, rows) {buckets}, {t.n_slots} slots, "
            f"{t.n_zero} zero rows, residual {t.n_overflow} (512-padded)")
    return line if build_s is None else f"{line}; build {build_s:.3f} s"


def sparse_phase(cuda, k1: dict, k2: dict, later: list) -> None:
    """Phase 5: the elliptic-shaped graph (``bench.py:208-209``) on the ELL
    route at n_h 300: ``spmm_impl="auto"`` must give the sigma tables and
    the ELL subset; 5 + 5 Scorer requests (f32 scores against the CPU),
    10 + 10 ``train()`` epochs, step times and stages, 3 f32 steps against
    the CPU. K1 and K2 must not launch anywhere in the phase; appends the
    profiled lines to ``later``."""
    import math

    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.synthetic import synthetic_like
    from ggad_tpu_torch.ops import ell_spmm as pe
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.serve import Scorer
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    ds = synthetic_like("elliptic")
    print(f"sparse graph (elliptic-shaped): nodes={ds.n_nodes} "
          f"edges={ds.n_edges} (+I {ds.n_edges + ds.n_nodes}) "
          f"feats={ds.feat_dim} labeled={len(labeled(ds))} "
          f"seeds={len(ds.abnormal_label_idx)} n_h={N_H}")
    scores = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        save_seeded_init(ckpt_dir, ds)
        for dtype in ("float32", "bfloat16"):
            scorer = None
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            scorer = Scorer(ckpt_dir, ds, embedding_dim=N_H,
                            spmm_dtype=dtype, device=cuda)
            torch.cuda.synchronize()
            prep = time.perf_counter() - t0
            held = (torch.cuda.memory_allocated() - base) / 1e6
            adj = scorer.trainer.adj
            if not (isinstance(adj, pe.ELLGraph) and adj.tables.bwd is None):
                raise RuntimeError(f"{dtype}: the elliptic-shaped graph did "
                                   f"not route to the forward ELL table "
                                   f"({type(adj).__name__})")
            t0 = time.perf_counter()
            pe.as_ell_graph(adj.graph, layout="sigma", transpose=False,
                            dtype=dtype)
            torch.cuda.synchronize()
            print(ell_tables_line(f"ELL forward table {dtype}",
                                  adj.tables.fwd, time.perf_counter() - t0))
            lat = []
            for _ in range(REQUESTS):
                t0 = time.perf_counter()
                res = scorer.score()
                lat.append((time.perf_counter() - t0) * 1e3)
            fwd = []
            for _ in range(REQUESTS):
                t0 = time.perf_counter()
                scorer.trainer.eval_scores(scorer.params)
                fwd.append((time.perf_counter() - t0) * 1e3)
            if (res.scores.shape != (ds.n_nodes,)
                    or not np.all(np.isfinite(res.scores))):
                raise RuntimeError(f"ELL {dtype}: bad scores")
            scores[dtype] = res
            print(f"ELL serve {dtype}: prepare {prep:.3f} s, device memory "
                  f"held {held:.1f} MB; request ms "
                  f"{[round(x, 3) for x in lat]} (median "
                  f"{statistics.median(lat):.3f}); eval_scores alone "
                  f"median {statistics.median(fwd):.3f} ms; AUROC "
                  f"{res.auc:.6f} AP {res.ap:.6f}")
            print(f"  eval forward by stage (ms, CUDA events): "
                  f"{json.dumps(stage_breakdown(scorer))}")
            later.append(partial(busy_line, f"ELL serve request {dtype}",
                                 scorer.score, statistics.median(lat),
                                 REQUESTS))
        cpu = Scorer(ckpt_dir, ds, embedding_dim=N_H, device="cpu").score()
    diff = np.abs(scores["float32"].scores - cpu.scores).max()
    np.testing.assert_allclose(scores["float32"].scores, cpu.scores,
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    print(f"ELL f32 card vs CPU scores max|d| {diff:.3g} (tol {SCORE_TOL}); "
          f"bf16 card vs CPU f32 max|d| "
          f"{np.abs(scores['bfloat16'].scores - cpu.scores).max():.3g}")

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
        if not (isinstance(tr.adj, pe.ELLGraph)
                and isinstance(tr.seed_adj, pe.ELLGraph)
                and isinstance(tr.aff_sub, pe.ELLAffinitySubset)):
            raise RuntimeError(f"ELL {dtype}: the trainer took another route "
                               f"({type(tr.adj).__name__}, "
                               f"{type(tr.aff_sub).__name__})")
        if dtype == "float32":
            for what, t in (("ELL transposed table", tr.adj.tables.bwd),
                            ("seed table [S x N]", tr.seed_adj.tables.fwd),
                            ("seed table [N x S]", tr.seed_adj.tables.bwd),
                            ("subset table [N x U]", tr.aff_sub.fwd),
                            ("subset table [U x N]", tr.aff_sub.bwd)):
                print(ell_tables_line(what, t))
        t0 = time.perf_counter()
        res = tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [r["loss"] for r in res.history if "loss" in r]
        if len(losses) != EPOCHS or not all(map(math.isfinite, losses)):
            raise RuntimeError(f"ELL {dtype}: bad losses {losses}")
        gen = torch.Generator(cuda).manual_seed(1)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(EPOCHS + 1)]
        ev[0].record()
        for i in range(EPOCHS):
            tr.train_step(gen)
            ev[i + 1].record()
        torch.cuda.synchronize()
        steps = [ev[i].elapsed_time(ev[i + 1]) for i in range(EPOCHS)]
        print(f"ELL train {dtype}: prepare {prep:.3f} s + training-only "
              f"{prep_train:.3f} s; device memory {mem[0]:.1f} MB + "
              f"training-only {mem[1]:.1f} MB; train() {EPOCHS} epochs "
              f"{wall:.3f} s; losses {[round(x, 6) for x in losses]}; "
              f"final AUROC {res.final_auc:.6f} AP {res.final_ap:.6f}")
        print(f"  step ms (CUDA events) {[round(x, 3) for x in steps]} "
              f"(median {statistics.median(steps):.3f})")
        print(f"  step by stage (ms, CUDA events): "
              f"{json.dumps(train_stages(tr, gen))}")
        later.append(partial(busy_line, f"ELL train step {dtype}",
                             partial(tr.train_step, gen),
                             statistics.median(steps), EPOCHS))
        later.append(partial(ell_sweeps_line, dtype, tr, gen))

    card_vs_cpu_steps(ds, cuda, "ELL train")
    if bcsr_spmm.launches or bcsr_sddmm_colsum.launches:
        raise RuntimeError(f"the ELL phase launched K1 {bcsr_spmm.launches} "
                           f"and K2 {bcsr_sddmm_colsum.launches} times")
    for rec in (*k1.values(), *k2.values()):
        rec["paths"]["sparse (ELL)"] = 0
    print("ELL phase: K1 launches 0, K2 launches 0")


def minibatch_phase(cuda, k1: dict, k2: dict, later: list) -> tuple:
    """Phase 6: the DGraph path on the full-size DGraph-shaped graph
    through ``MiniBatchTrainer`` at the model's full width (emb 64,
    fanouts 16/8, batch 150 + 50, 150 batches an epoch); K1 and K2 must
    not launch anywhere in the phase; appends the profiled step line to
    ``later``. Returns the dataset, ``adj + I`` and the split, which the
    next phase takes over."""
    import math

    import numpy as np
    import scipy.sparse as sp
    import torch

    from ggad_tpu_torch import native
    from ggad_tpu_torch.datasets.loaders import load_dataset
    from ggad_tpu_torch.datasets.splits import minibatch_split_for
    from ggad_tpu_torch.ops import metrics as pm
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    native.reset_calls()
    t_phase = t0 = time.perf_counter()
    ds = load_dataset("dgraphfin")       # the synthetic fallback, scale 1
    t1 = time.perf_counter()
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    t2 = time.perf_counter()
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split_for(
        ds.name, ds.ano_labels, seed=0)
    t3 = time.perf_counter()
    inputs = dict(adj=adj, features=ds.features, labels=labels,
                  idx_train=idx_train, idx_anomaly=idx_anom,
                  idx_valid=idx_valid, idx_test=idx_test)
    shape = dict(emb_dim=64, fanout1=16, fanout2=8, batch_size=150,
                 n_anom_per_batch=50, num_batches=150)
    base = torch.cuda.memory_allocated()
    tr = MiniBatchTrainer(**inputs, **shape, num_epochs=MB_EPOCHS,
                          valid_epochs=MB_EPOCHS - 1, device=cuda)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    ran = {k: n for k, n in native.calls.items() if n}
    if not (ran.get("symmetrize") and ran.get("build_indptr")):
        raise RuntimeError(f"the DGraph host build took the Python route: "
                           f"host library calls {native.calls}")
    held = (torch.cuda.memory_allocated() - base) / 1e6
    table_mb = (tr.table.indptr.numel() + tr.table.indices.numel()) * 4e-6
    print(f"minibatch graph (DGraph-shaped): nodes={ds.n_nodes} "
          f"edges={ds.n_edges} (+I {adj.nnz}) feats={ds.feat_dim}; split "
          f"train={len(idx_train)} valid={len(idx_valid)} "
          f"test={len(idx_test)} seeds={len(idx_anom)}; pools normal="
          f"{len(tr._train_pool)} anomaly={len(tr._anom_pool)}")
    print(f"  host build: load_dataset {t1 - t0:.3f} s, adj + I "
          f"{t2 - t1:.3f} s, minibatch_split_for {t3 - t2:.3f} s, trainer "
          f"preparation (smoothing, pools, table and features to the card) "
          f"{t4 - t3:.3f} s; host library entry points called {ran} "
          f"(none else)")
    print(f"  device memory held: {held:.1f} MB (table {table_mb:.1f} MB, "
          f"features {tr.feats.numel() * 4e-6:.1f} MB)")
    # the same load on the Python route (scipy's maximum(adj.T)): the
    # same adjacency, and what the host library saves
    available = native.available
    native.available = lambda: False
    try:
        t0 = time.perf_counter()
        py = load_dataset("dgraphfin").adj
        t_py = time.perf_counter() - t0
    finally:
        native.available = available
    if not all(np.array_equal(getattr(py, k), getattr(ds.adj, k))
               for k in ("indptr", "indices", "data")):
        raise RuntimeError("the DGraph adjacency differs between the "
                           "native and the Python route")
    print(f"  load_dataset on the Python route (scipy's maximum(adj.T)) "
          f"{t_py:.3f} s, native {t1 - t_phase:.3f} s; adjacency equal")
    del py

    t0 = time.perf_counter()
    res = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in res.history]
    vals = [(r["epoch"], r["val_auc"], r["val_ap"]) for r in res.history
            if "val_auc" in r]
    if (len(losses) != MB_EPOCHS or not all(map(math.isfinite, losses))
            or len(vals) < 2 or vals[0][0] >= MB_EPOCHS - 1
            or not all(math.isfinite(v) for v in res.test_metrics.values())
            or not 0 <= res.best_epoch < MB_EPOCHS):
        raise RuntimeError(f"minibatch train(): bad result {res.history} "
                           f"{res.test_metrics}")
    print(f"minibatch train(): {MB_EPOCHS} epochs + {len(vals)} validations "
          f"+ test {wall:.3f} s (steps alone {res.train_time_s:.3f} s); "
          + json.dumps({"losses": [{k: r[k] for k in (
              "loss", "loss_cls", "loss_constraint", "loss_rec")}
              for r in res.history],
              "val": [{"epoch": e, "auc": a, "ap": p} for e, a, p in vals],
              "best_epoch": res.best_epoch, "test": res.test_metrics}))

    gen = torch.Generator(cuda).manual_seed(1)
    batches = tr.draw_batches(np.random.default_rng(1))
    b = batches.shape[1]
    u1 = tr.draw((tr.num_batches, b, 16), gen)
    u2 = tr.draw((tr.num_batches, b * 16, 8), gen)
    for i in range(3):                                       # warm-up
        tr.train_step(batches[i], u1[i], u2[i])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(MB_STEPS + 1)]
    ev[0].record()
    for i in range(MB_STEPS):
        tr.train_step(batches[3 + i], u1[3 + i], u2[3 + i])
        ev[i + 1].record()
    torch.cuda.synchronize()
    steps = [ev[i].elapsed_time(ev[i + 1]) for i in range(MB_STEPS)]
    step_ms = statistics.median(steps)
    t0 = time.perf_counter()
    last = tr.train_epoch(batches, gen)
    torch.stack(list(last)).tolist()
    epoch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probs = tr.score_nodes(None, idx_valid)
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = pm.prob_to_pred(probs, tr.thres)
    pm.roc_auc(labels[idx_valid], probs)
    pm.average_precision(labels[idx_valid], probs)
    pm.f1_scores(labels[idx_valid], preds)
    pm.gmean_from_confusion(pm.confusion(labels[idx_valid], preds))
    metrics_s = time.perf_counter() - t0
    print(f"  step ms (CUDA events, {MB_STEPS} after 3 warm-up) "
          f"{[round(x, 3) for x in steps]} (median {step_ms:.3f}); one epoch "
          f"({tr.num_batches} steps, one read) {epoch_s:.3f} s; score_nodes "
          f"over the validation split ({len(idx_valid)} nodes) {score_s:.3f} "
          f"s = {len(idx_valid) / score_s:.0f} nodes/s; host metrics on it "
          f"{metrics_s:.3f} s")
    later.append(partial(busy_line, "minibatch train step",
                         lambda: tr.train_step(batches[0], u1[0], u2[0]),
                         step_ms, MB_STEPS))
    minibatch_card_vs_cpu(tr, inputs, shape, cuda)

    if bcsr_spmm.launches or bcsr_sddmm_colsum.launches:
        raise RuntimeError(f"the minibatch phase launched K1 "
                           f"{bcsr_spmm.launches} and K2 "
                           f"{bcsr_sddmm_colsum.launches} times")
    for rec in (*k1.values(), *k2.values()):
        rec["paths"]["minibatch (DGraph)"] = 0
    print(f"minibatch phase: K1 launches 0, K2 launches 0; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ds, adj, (idx_train, idx_valid, idx_test, labels, idx_anom)


def minibatch_card_vs_cpu(tr, inputs: dict, shape: dict, cuda) -> None:
    """``MB_CPU_STEPS`` steps from the same initial weights, batches and
    draws (made once on the CPU) on the card and on the CPU: the sampled
    ids equal, the four loss fields within ``LOSS_TOL``; then
    ``score_nodes`` on ``MB_CPU_SCORES`` nodes on the same draws, within
    ``SCORE_TOL``."""
    import numpy as np
    import torch

    from ggad_tpu_torch.sampler.neighbor import sample_two_hop
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    gen = torch.Generator().manual_seed(2)
    cpu = MiniBatchTrainer(**inputs, **shape, device="cpu")
    batches = cpu.draw_batches(np.random.default_rng(2))[:MB_CPU_STEPS]
    b = batches.shape[1]
    u1 = torch.rand(MB_CPU_STEPS, b, 16, generator=gen)
    u2 = torch.rand(MB_CPU_STEPS, b * 16, 8, generator=gen)
    n_chunks = -(-MB_CPU_SCORES // cpu.eval_batch)
    ue = torch.rand(n_chunks, cpu.eval_batch, 16, generator=gen)
    nodes = np.random.default_rng(3).choice(tr.idx_valid, MB_CPU_SCORES,
                                            replace=False)
    runs = []
    for t in (tr, cpu):                 # both start from the seed-0 init
        dev = t.device
        t.reset()
        ids = [torch.cat([x.reshape(-1).cpu() for x in sample_two_hop(
            t.table, batches[i].to(dev), 16, 8, u1[i].to(dev),
            u2[i].to(dev))[::2]]) for i in range(MB_CPU_STEPS)]
        losses = [[float(x) for x in t.train_step(
            batches[i].to(dev), u1[i].to(dev), u2[i].to(dev))]
            for i in range(MB_CPU_STEPS)]
        t.draws = lambda s: ue
        scores = t.score_nodes(None, nodes)
        t.draws = None
        runs.append((ids, losses, scores))
    (card_ids, card, card_s), (cpu_ids, ref, cpu_s) = runs
    if not all(torch.equal(a, c) for a, c in zip(card_ids, cpu_ids)):
        raise RuntimeError("minibatch: the card sampled other ids than the "
                           "CPU from the same draws")
    diff = max(abs(a - c) for sa, sc in zip(card, ref)
               for a, c in zip(sa, sc))
    for sa, sc in zip(card, ref):
        for a, c in zip(sa, sc):
            if not abs(a - c) <= LOSS_TOL * (1 + abs(c)):
                raise RuntimeError(f"minibatch: card losses {card} vs CPU "
                                   f"{ref}")
    np.testing.assert_allclose(card_s, cpu_s, rtol=SCORE_TOL, atol=SCORE_TOL)
    print(f"minibatch card vs CPU, {MB_CPU_STEPS} steps from the same "
          f"weights, batches and draws: sampled ids equal; four loss fields "
          f"max|d| {diff:.3g} (tol {LOSS_TOL}); totals card "
          f"{[round(x[0], 6) for x in card]} cpu "
          f"{[round(x[0], 6) for x in ref]}; score_nodes on {MB_CPU_SCORES} "
          f"nodes max|d| {np.abs(card_s - cpu_s).max():.3g} "
          f"(tol {SCORE_TOL})")



class SeededDraws:
    """The same sequence of uniform draws on every device: each request
    is a fresh CPU draw of one seeded generator."""

    def __init__(self, seed: int):
        import torch

        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, shape):
        import torch

        return torch.rand(shape, generator=self.gen)


def mbb_run(name: str, inputs: dict, idx_anom, device, **kw):
    """One minibatch baseline's run object (``train.baselines``) at the
    reference's width on ``inputs``."""
    from ggad_tpu_torch.train import baselines as tb

    if name in tb.MINIBATCH_CLASSIFIERS:
        return tb.MiniBatchClassifierRun(**inputs, name=name,
                                         idx_anomaly=idx_anom,
                                         device=device, **kw)
    return tb.MiniBatchReconRun(**inputs, name=name, device=device, **kw)


def mbb_main_path(name: str, inputs: dict, idx_anom, cuda,
                  later: list) -> None:
    """``name`` trained for ``MBB_EPOCHS`` epochs through its run's
    ``train()`` (what ``run_minibatch_*`` calls), then timed: step median,
    one epoch, ``idx_test`` scoring apart from its host metrics, held and
    peak device memory."""
    import math

    import numpy as np
    import torch

    from ggad_tpu_torch.ops import metrics as pm

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run = mbb_run(name, inputs, idx_anom, cuda, num_epochs=MBB_EPOCHS)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() - base) / 1e6
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(run.losses).tolist()
    if (len(losses) != MBB_EPOCHS * run.num_batches
            or not all(map(math.isfinite, losses))
            or not all(math.isfinite(v) for v in res.values())):
        raise RuntimeError(f"{name}: bad result {res}, losses {losses}")

    gen = torch.Generator(cuda).manual_seed(1)
    batches, ys = run.draw_batches(np.random.default_rng(1))
    nb, b = batches.shape
    us = [run.draw((nb, *s), gen) for s in run.sample_shapes(b)]

    def step(i):
        return run.step(batches[i], None if ys is None else ys[i],
                        [u[i] for u in us])

    for i in range(3):                                       # warm-up
        step(i)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(MB_STEPS + 1)]
    ev[0].record()
    for i in range(MB_STEPS):
        step(3 + i)
        ev[i + 1].record()
    torch.cuda.synchronize()
    steps = [ev[i].elapsed_time(ev[i + 1]) for i in range(MB_STEPS)]
    step_ms = statistics.median(steps)
    t0 = time.perf_counter()
    run.train_epoch(batches, ys).item()
    epoch_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6 - held
    idx_test = run.idx_test
    t0 = time.perf_counter()
    probs = run.score_nodes(idx_test)
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y = run.labels[np.asarray(idx_test)]
    pm.roc_auc(y, probs)
    pm.average_precision(y, probs)
    metrics_s = time.perf_counter() - t0
    print(f"{name}: run object {prep_s:.3f} s (table and features to the "
          f"card), held {held:.1f} MB; train() {MBB_EPOCHS} epochs x "
          f"{run.num_batches} steps (+ validations, test) {wall:.3f} s; "
          f"losses first/last {losses[0]:.6f} / {losses[-1]:.6f}; "
          + json.dumps(res))
    print(f"  step ms (CUDA events, {MB_STEPS} after 3 warm-up) "
          f"{[round(x, 3) for x in steps]} (median {step_ms:.3f}); one epoch "
          f"({nb} steps, one read) {epoch_s:.3f} s; score_nodes over "
          f"idx_test ({len(idx_test)} nodes) {score_s:.3f} s = "
          f"{len(idx_test) / score_s:.0f} nodes/s; host metrics "
          f"{metrics_s:.3f} s; peak device memory above the held "
          f"{peak:.1f} MB (train(), its scoring, the timed steps)")
    later.append(partial(busy_line, f"{name} train step",
                         lambda: step(0), step_ms, MB_STEPS))


def mbb_card_vs_cpu(name: str, inputs: dict, idx_anom, cuda,
                    steps: int = MBB_CPU_STEPS, n_scores: int = MB_CPU_SCORES,
                    **run_kw) -> None:
    """``steps`` steps and ``n_scores`` scores of ``name`` on the card and
    on the CPU from the same initial weights, batch ids (equal), draws and
    (AEGIS-mb) noise table: losses and scores within 1e-4. ``run_kw`` sets
    fields of both runs."""
    import numpy as np
    import torch

    kw = dict(num_batches=steps, draws=SeededDraws(3), **run_kw)
    out, extra = [], {}
    nodes = np.random.default_rng(4).choice(
        inputs["idx_valid"], n_scores, replace=False)
    for device in (cuda, "cpu"):
        run = mbb_run(name, inputs, idx_anom, device, **kw, **extra)
        kw["draws"] = SeededDraws(3)
        extra = dict(initial_params={k: v.detach().clone() for k, v in
                                     run.model.state_dict().items()})
        if name == "aegis-minibatch":
            extra["noise_table"] = run.noise_table
        batches, ys = run.draw_batches(np.random.default_rng(5))
        run.train_epoch(batches, ys)
        out.append((batches.cpu(), torch.stack(run.losses).tolist(),
                    run.score_nodes(nodes)))
    (card_ids, card, card_s), (cpu_ids, cpu, cpu_s) = out
    if not torch.equal(card_ids, cpu_ids):
        raise RuntimeError(f"{name}: the card drew other batch ids")
    diff = within(card, cpu, f"{name} card vs CPU losses")
    np.testing.assert_allclose(card_s, cpu_s, rtol=SCORE_TOL, atol=SCORE_TOL)
    print(f"  {name} card vs CPU, {steps} steps from the same weights, "
          f"batch ids (equal), draws"
          f"{' and noise table' if name == 'aegis-minibatch' else ''}: "
          f"losses max|d| {diff:.3g} (card {[round(x, 6) for x in card]}); "
          f"{n_scores} scores max|d| {np.abs(card_s - cpu_s).max():.3g} "
          f"(tol {SCORE_TOL})")


def pcgnn_relations_card_vs_cpu(cuda) -> None:
    """PC-GNN on three relations of their own (``synthetic_gad(
    n_relations=3)``, small), card against CPU."""
    import numpy as np
    import scipy.sparse as sp

    from ggad_tpu_torch.datasets.splits import minibatch_split
    from ggad_tpu_torch.datasets.synthetic import synthetic_gad

    ds = synthetic_gad(n_nodes=20_000, avg_degree=10, feat_dim=17,
                       n_relations=3, seed=0)
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split(
        ds.ano_labels, seed=0)
    print(f"PC-GNN on 3 relations: {ds.n_nodes} nodes, relation nnz "
          f"{[r.nnz for r in ds.relations]}")
    mbb_card_vs_cpu("pcgnn", dict(
        adj=adj, features=ds.features, labels=labels, idx_train=idx_train,
        idx_valid=idx_valid, idx_test=idx_test), idx_anom, cuda,
        steps=MBB_REL_STEPS, n_scores=1024, relations=ds.relations)


def exact_replay(ds, split, cuda) -> None:
    """The exact set-union replay on the DGraph-shaped graph (symmetrized,
    no self-loops): ``EXACT_BATCHES`` batches of 150 + 50, one pad shape
    rounded to 64, ``torch.optim.Adam(1e-3, weight_decay=0.007)``, card
    against CPU on every batch, then ``exact_score_nodes`` of
    ``EXACT_SCORES`` validation nodes in 150-node slices."""
    import numpy as np
    import torch

    from ggad_tpu_torch.models import sage_exact as px

    idx_train, idx_valid, _, labels, idx_anom = split
    t0 = time.perf_counter()
    indptr, indices = px.replay_adjacency(ds.adj)
    adj_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    normals = idx_train[labels[idx_train] == 0]
    anoms = np.unique(np.concatenate([idx_anom,
                                      idx_train[labels[idx_train] == 1]]))
    batches = []
    for _ in range(EXACT_BATCHES):
        nodes = np.concatenate([rng.choice(normals, 150),
                                rng.choice(anoms, 50)])
        batches.append((nodes, labels[nodes].astype(np.float32)))
    t0 = time.perf_counter()
    u_pad, e_pad = px.exact_pads(indptr, indices, [b[0] for b in batches])
    pads_s = time.perf_counter() - t0
    mask2_bytes = u_pad * e_pad * 4
    print(f"exact replay: replay adjacency {adj_s:.3f} s ({len(indices)} "
          f"entries); pads over {EXACT_BATCHES} batches {pads_s:.3f} s: "
          f"U_pad {u_pad}, E_pad {e_pad}, mask2 {mask2_bytes / 1e9:.3f} GB "
          f"f32")
    if mask2_bytes > MASK2_LIMIT:
        raise RuntimeError(f"mask2 of {mask2_bytes} bytes over the limit")
    init = px.init_exact_params(ds.feat_dim, 64, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    sides = []
    for device in (cuda, torch.device("cpu")):
        params = {k: v.detach().to(device, copy=True).requires_grad_()
                  for k, v in init.items()}
        feats = torch.as_tensor(ds.features).to(device)
        opt = torch.optim.Adam(params.values(), lr=1e-3, weight_decay=0.007)
        sides.append((device, params, feats, opt, []))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_s, step_ms = [], []
    for nodes, y in batches:
        t0 = time.perf_counter()
        b_cpu = px.build_exact_batch(indptr, indices, nodes, y, u_pad,
                                     e_pad, device="cpu")
        build_s.append(time.perf_counter() - t0)
        for j, (device, params, feats, opt, losses) in enumerate(sides):
            b = b_cpu.to(device)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            opt.zero_grad()
            total, _ = px.exact_losses(params, feats, b)
            total.backward()
            opt.step()
            ev[1].record()
            torch.cuda.synchronize()
            if j == 0:                                  # the card's step
                step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(total.item())
            del b
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    card, cpu = sides[0][4], sides[1][4]
    diff = within(card, cpu, "exact replay losses")
    nodes = np.random.default_rng(7).choice(idx_valid, EXACT_SCORES,
                                            replace=False)
    scores, eval_s = [], []
    for _, params, feats, _, _ in sides:
        t0 = time.perf_counter()
        scores.append(px.exact_score_nodes(params, feats, indptr, indices,
                                           nodes))
        eval_s.append(time.perf_counter() - t0)
    np.testing.assert_allclose(scores[0], scores[1], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    print(f"  host build a batch (set unions + dense masks) "
          f"{[round(x, 3) for x in build_s]} s (median "
          f"{statistics.median(build_s):.3f}); card step ms (CUDA events, "
          f"batch on the card) {[round(x, 3) for x in step_ms]} (median "
          f"{statistics.median(step_ms):.3f}); peak device memory "
          f"{peak:.1f} MB; losses card {[round(x, 6) for x in card]}, max|d| "
          f"vs CPU {diff:.3g}; exact_score_nodes of {EXACT_SCORES} "
          f"validation nodes (150 a slice) {eval_s[0]:.3f} s on the card "
          f"(CPU {eval_s[1]:.3f} s), "
          f"max|d| vs CPU {np.abs(scores[0] - scores[1]).max():.3g}")


def rwr_check(ds, split, cuda) -> None:
    """``rwr_subgraphs`` on ``RWR_SEEDS`` seeds of the raw DGraph-shaped
    graph (size 4, walk 12) and ``pick_step`` for as many ids, card and
    CPU from the same draws: ids and masks equal."""
    import numpy as np
    import torch

    from ggad_tpu_torch.sampler import rwr
    from ggad_tpu_torch.sampler.neighbor import NeighborTable

    idx_train, _, _, labels, _ = split
    gen = torch.Generator().manual_seed(8)
    seeds = torch.randint(0, ds.n_nodes, (RWR_SEEDS,), generator=gen,
                          dtype=torch.int32)
    u_step, u_restart = torch.rand(2, RWR_WALK, RWR_SEEDS, generator=gen)
    u = torch.rand(RWR_SEEDS, generator=gen)
    idx = torch.as_tensor(np.asarray(idx_train, np.int64))
    y = torch.as_tensor(np.asarray(labels))[idx]
    out, times = [], []
    for device in (cuda, "cpu"):
        table = NeighborTable.from_scipy(ds.adj, device=device)
        d_idx = idx.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, mask = rwr.rwr_subgraphs(
            table, seeds.to(device), subgraph_size=RWR_SIZE,
            u_step=u_step.to(device), u_restart=u_restart.to(device))
        picked = rwr.pick_step(d_idx, y.to(device), table.degrees_of(d_idx),
                               u.to(device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append([t.cpu() for t in (nodes, mask, picked)])
        del table
    if not all(torch.equal(a, b) for a, b in zip(*out)):
        raise RuntimeError("rwr: the card's ids or masks differ from the "
                           "CPU's")
    filled = out[0][1].sum(1)
    print(f"rwr: {RWR_SEEDS} seeds, subgraph {RWR_SIZE}, walk {RWR_WALK} "
          f"and pick_step of {RWR_SEEDS} ids over {len(idx)} train ids: "
          f"card equal to CPU (ids, masks); filled slots mean "
          f"{filled.mean():.3f}; card {times[0]:.3f} s, CPU {times[1]:.3f} "
          f"s (host clock)")


def minibatch_baselines_phase(cuda, k1: dict, k2: dict, later: list, ds,
                              adj, split) -> None:
    """Phase 6b: the minibatch baselines on phase 6's DGraph-shaped graph,
    ``adj + I`` and split; K1 and K2 must launch 0 times in the phase."""
    import torch

    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm

    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    t_phase = time.perf_counter()
    idx_train, idx_valid, idx_test, labels, idx_anom = split
    inputs = dict(adj=adj, features=ds.features, labels=labels,
                  idx_train=idx_train, idx_valid=idx_valid,
                  idx_test=idx_test)
    print(f"minibatch baselines on the DGraph-shaped graph: emb 64, batch "
          f"150 (+ 50 anomalies for sage and pcgnn), 50 batches an epoch, "
          f"{MBB_EPOCHS} epochs; fanouts sage 5, pcgnn 16/8 x 3 relations "
          f"(one shared table), the reconstructions 16")
    for name in MBB_MODELS:
        mbb_main_path(name, inputs, idx_anom, cuda, later)
        mbb_card_vs_cpu(name, inputs, idx_anom, cuda)
    pcgnn_relations_card_vs_cpu(cuda)
    exact_replay(ds, split, cuda)
    rwr_check(ds, split, cuda)
    torch.cuda.synchronize()
    if bcsr_spmm.launches or bcsr_sddmm_colsum.launches:
        raise RuntimeError(f"the minibatch baselines launched K1 "
                           f"{bcsr_spmm.launches} and K2 "
                           f"{bcsr_sddmm_colsum.launches} times")
    for rec in (*k1.values(), *k2.values()):
        rec["paths"]["minibatch baselines (DGraph)"] = 0
    print(f"minibatch baselines phase: K1 launches 0, K2 launches 0; "
          f"{time.perf_counter() - t_phase:.1f} s")


def zoo_run(name: str, ds, faithful: bool, device, **kw):
    """A full-batch baseline's run object (``train.baselines``) at the
    zoo's full width: n_h ``N_H``; GAAN at its fixed noise 16 and hid 64."""
    from ggad_tpu_torch.train import baselines as tb

    if name in tb.RECONSTRUCTION:
        return tb.ReconstructionRun(name, ds, embedding_dim=N_H,
                                    device=device, **kw)
    if name == "ocgnn":
        return tb.OCGNNRun(ds, embedding_dim=N_H, device=device, **kw)
    if name == "aegis":
        return tb.AEGISRun(ds, embedding_dim=N_H, faithful=faithful,
                           device=device, **kw)
    return tb.GAANRun(ds, device=device, **kw)


def zoo_label(name: str, faithful) -> str:
    return name + {None: "", False: " (intended)",
                   True: " (faithful)"}[faithful]


def zoo_main_path(name: str, ds, faithful, cuda):
    """The runner a user calls (``train.baselines.run_*``, which the CLI's
    ``--model`` reaches) for ``ZOO_EPOCHS`` epochs at n_h 300 and the
    CLI's evaluation cadence; AEGIS after ``ZOO_PRETRAIN`` pretrain
    epochs."""
    from ggad_tpu_torch.train import baselines as tb

    kw = dict(num_epoch=ZOO_EPOCHS, eval_every=ZOO_EVAL_EVERY, device=cuda)
    if name in tb.RECONSTRUCTION:
        return tb.run_reconstruction(name, ds, embedding_dim=N_H, **kw)
    if name == "ocgnn":
        return tb.run_ocgnn(ds, embedding_dim=N_H, **kw)
    if name == "aegis":
        return tb.run_aegis(ds, recon_num_epoch=ZOO_PRETRAIN,
                            embedding_dim=N_H, faithful=faithful, **kw)
    return tb.run_gaan(ds, **kw)


def zoo_card_vs_cpu(name: str, ds, faithful: bool, cuda):
    """``ZOO_CPU_STEPS`` steps (AEGIS: a pretrain and an adversarial step)
    on the card (``auto``, BCSR on the photo shape) and on the CPU (the
    COO route, the same function, to keep the CPU leg short) from the same
    weights (the card run's seeded init, copied) and noise: losses within
    ``LOSS_TOL``, scores within ``SCORE_TOL``. Returns the card run, its
    noise then drawn on the card, and the largest differences."""
    import numpy as np

    from ggad_tpu_torch.ops.bcsr_spmm import BCSRGraph

    kw = {}
    if name in ("aegis", "gaan"):
        kw["noise_seq"] = [np.random.default_rng(i).standard_normal(
            (ds.n_nodes, 16)).astype(np.float32)
            for i in range(ZOO_CPU_STEPS)]
    card = zoo_run(name, ds, faithful, cuda, **kw)
    if not isinstance(card.adj, BCSRGraph):
        raise RuntimeError(f"zoo {name}: the photo graph did not route to "
                           f"BCSR ({type(card.adj).__name__})")
    init = {k: v.cpu() for k, v in card.model.state_dict().items()}
    cpu = zoo_run(name, ds, faithful, "cpu", spmm_impl="coo",
                  initial_params=init, **kw)
    calls = (["pretrain_step", "step"] if name == "aegis"
             else ["step"] * ZOO_CPU_STEPS)
    got = []
    for run in (card, cpu):
        got.append([(float(getattr(run, c)()),
                     None if c == "pretrain_step" else run.scores().cpu())
                    for c in calls])
    loss_d = score_d = 0.0
    for (la, sa), (lb, sb) in zip(*got):
        if not abs(la - lb) <= LOSS_TOL * (1 + abs(lb)):
            raise RuntimeError(f"zoo {name}: card losses {got[0]} vs CPU "
                               f"{got[1]}")
        loss_d = max(loss_d, abs(la - lb))
        if sa is not None:
            np.testing.assert_allclose(sa.numpy(), sb.numpy(),
                                       rtol=SCORE_TOL, atol=SCORE_TOL)
            score_d = max(score_d, float((sa - sb).abs().max()))
    if "noise_seq" in kw:
        card.next_noise = card.noise_source(None, 1, 16)
    return card, loss_d, score_d


def zoo_step_ms(run, call: str, k1_each: int,
                base: int) -> tuple[float, float]:
    """Median of ``ZOO_STEPS`` calls of ``run.<call>`` (CUDA events, after
    one warm-up) and the peak device memory over them above ``base``
    bytes (MB); K1 must launch ``k1_each`` times a call."""
    import torch

    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm

    fn = getattr(run, call)
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bcsr_spmm.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(ZOO_STEPS + 1)]
    ev[0].record()
    for i in range(ZOO_STEPS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    if bcsr_spmm.launches != ZOO_STEPS * k1_each:
        raise RuntimeError(f"{call}: K1 launched {bcsr_spmm.launches} times "
                           f"in {ZOO_STEPS} calls, expected {k1_each} each")
    steps = [ev[i].elapsed_time(ev[i + 1]) for i in range(ZOO_STEPS)]
    return (statistics.median(steps),
            (torch.cuda.max_memory_allocated() - base) / 1e6)


def zoo_phase(cuda, k1: dict, k2: dict, later: list) -> None:
    """The full-batch baseline zoo on the photo-shaped graph at n_h 300:
    each model's main path with K1's exact count, its step median and
    memory, 2 steps against the CPU; then OCGNN on the elliptic-shaped
    graph under ``auto`` (the ELL route, K1 = K2 = 0); appends each
    model's profiled step to ``later``."""
    import math

    import torch

    from ggad_tpu_torch.cli import build_parser
    from ggad_tpu_torch.datasets.synthetic import photo_bench, synthetic_like
    from ggad_tpu_torch.graph import from_scipy
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.ops.normalize import normalize_adj_reference
    from ggad_tpu_torch.train import baselines as tb
    from ggad_tpu_torch.train.full_batch import spmm_route

    t_phase = time.perf_counter()
    ds = photo_bench()
    for name, faithful in ZOO:
        label = zoo_label(name, faithful)
        per = ZOO_K1.get(name, {})
        bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
        res = zoo_main_path(name, ds, faithful, cuda)
        torch.cuda.synchronize()
        n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
        evals = sum(1 for e in range(ZOO_EPOCHS)
                    if e % ZOO_EVAL_EVERY == 0 or e == ZOO_EPOCHS - 1)
        want = (ZOO_EPOCHS * per.get("step", 0) + evals * per.get("eval", 0)
                + (ZOO_PRETRAIN * per["pretrain"] if name == "aegis" else 0))
        if (n1, n2) != (want, 0):
            raise RuntimeError(f"zoo {label}: K1 {n1}, K2 {n2} launches; "
                               f"expected K1 {want}, K2 0")
        losses = [r["loss"] for r in res.history]
        if (len(losses) != evals + (ZOO_PRETRAIN if name == "aegis" else 0)
                or not all(map(math.isfinite, losses))
                or not math.isfinite(res.auc)):
            raise RuntimeError(f"zoo {label}: bad history {res.history}")
        k1["float32"]["paths"][f"zoo {label}"] = n1
        for rec in (k1["bfloat16"], *k2.values()):
            rec["paths"][f"zoo {label}"] = 0

        gc.collect()
        base = torch.cuda.memory_allocated()
        run, loss_d, score_d = zoo_card_vs_cpu(name, ds, faithful, cuda)
        torch.cuda.synchronize()
        held = (torch.cuda.memory_allocated() - base) / 1e6
        times = {}
        if name == "aegis":
            times["pretrain step"] = zoo_step_ms(run, "pretrain_step",
                                                 per["pretrain"], base)
        times["step"] = zoo_step_ms(run, "step", per.get("step", 0), base)
        print(f"zoo {label}: {ZOO_EPOCHS} epochs"
              + (f" after {ZOO_PRETRAIN} pretrain" if name == "aegis"
                 else "")
              + f" in {res.wall_time_s:.3f} s, K1 launches {n1}, K2 0; "
              f"losses {[round(x, 6) for x in losses]}; final AUROC "
              f"{res.auc:.6f} AP {res.ap:.6f}")
        print("  " + "; ".join(
            f"{k} median {ms:.3f} ms (CUDA events, {ZOO_STEPS} after a "
            f"warm-up), peak device memory {peak:.1f} MB"
            for k, (ms, peak) in times.items())
            + f" (above what the earlier phases hold); device memory held "
            f"by the run after 2 steps {held:.1f} MB")
        print("  card vs CPU (COO route on the CPU), "
              + ("a pretrain and an adversarial step" if name == "aegis"
                 else f"{ZOO_CPU_STEPS} steps")
              + f" from the same weights and noise: losses max|d| "
              f"{loss_d:.3g} (tol {LOSS_TOL}·(1 + |CPU|)), scores max|d| "
              f"{score_d:.3g} (tol {SCORE_TOL}·(1 + |CPU|))")
        later.append(partial(busy_line, f"zoo {label} step", run.step,
                             times["step"][0], ZOO_STEPS))
        del run

    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    ell = synthetic_like("elliptic")
    adj, _ = normalize_adj_reference(from_scipy(ell.adj, device=cuda))
    route = spmm_route(adj, "auto")
    del adj
    args = build_parser().parse_args(
        ["--model", "ocgnn", "--num_epoch", "3", "--embedding_dim", str(N_H),
         "--device", str(cuda)])
    t0 = time.perf_counter()
    rec = tb.run_baseline("ocgnn", ell, args)
    torch.cuda.synchronize()
    if route != "ell" or bcsr_spmm.launches or bcsr_sddmm_colsum.launches:
        raise RuntimeError(f"zoo ocgnn on the elliptic shape: route {route}, "
                           f"K1 {bcsr_spmm.launches}, K2 "
                           f"{bcsr_sddmm_colsum.launches}")
    if not math.isfinite(rec["auc"]):
        raise RuntimeError(f"zoo ocgnn (ELL): {rec}")
    for paths in (*k1.values(), *k2.values()):
        paths["paths"]["zoo ocgnn (ELL)"] = 0
    print(f"zoo ocgnn on the elliptic-shaped graph under auto: route {route}, "
          f"3 epochs {time.perf_counter() - t0:.3f} s, K1 0, K2 0; "
          f"{json.dumps(rec)}")
    print(f"zoo phase: {time.perf_counter() - t_phase:.1f} s")


def tam_members(raw, ds, cuda):
    """The photo run's members as ``run_tam`` makes them at seed 0: the
    stacked seeded init, then the cut values from the generator's next
    draws; and the features on the card."""
    import torch

    from ggad_tpu_torch.models import tam

    gen = torch.Generator().manual_seed(0)
    params = tam.init_members(ds.feat_dim, N_H, TAM_CUTTING, gen)
    x = torch.as_tensor(ds.features, device=cuda)
    vals = tam.cut_stack(raw, x, TAM_CUTTING, 1,
                         [torch.rand(ds.n_nodes, generator=gen)
                          for _ in range(TAM_CUTTING)])
    return x, params, vals


def within(got, ref, what: str) -> float:
    """Raise unless |got − ref| ≤ 1e-4·(1 + |ref|) everywhere; the largest
    difference."""
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.all(
            np.abs(got - ref) <= LOSS_TOL * (1 + np.abs(ref))):
        raise RuntimeError(f"{what}: max|d| {np.abs(got - ref).max()} "
                           f"above {LOSS_TOL}·(1 + |ref|)")
    return float(np.abs(got - ref).max())


def tam_compare(got, ref, what: str) -> dict:
    """Messages, scores and recorded losses of two ``TAMResult``s within
    1e-4·(1 + |ref|); the largest difference of each."""
    out = {f: within(getattr(got, f), getattr(ref, f), f"{what} {f}")
           for f in ("member_messages", "scores", "per_round_scores")}
    out["losses"] = max(within(got.loss_history[ep], v, f"{what} losses")
                        for ep, v in ref.loss_history.items())
    return out


def tam_epoch_line(ens, pair, n: int, wall_ms: float) -> str:
    """A TAM epoch's device time against its median wall time (busy share,
    device ops), and its parts alone at the epoch's shapes: the 4 K1
    launches, the einsums forward and backward, the ELL affinities forward
    and backward; the rest (elementwise, Adam, padding) is the
    difference."""
    import torch

    from ggad_tpu_torch.ops.sddmm import node_affinity
    from ggad_tpu_torch.ops import bcsr_spmm as pb

    dev, _, ops = device_ms(ens.step, iters=TAM_TIMED)
    gen = torch.Generator(ens.x.device).manual_seed(3)
    m = TAM_CUTTING

    def randn(*shape, grad=False):
        return torch.randn(*shape, device=ens.x.device, generator=gen,
                           requires_grad=grad)

    rows = pair.fwd.n_cols
    h1, h2 = randn(rows, 2 * N_H), randn(rows, N_H)
    w1 = randn(m, 2 * N_H, ens.x.shape[1], grad=True)
    w2 = randn(m, N_H, 2 * N_H, grad=True)
    a1 = randn(m, n, 2 * N_H, grad=True)
    g1, g2 = randn(m, n, 2 * N_H), randn(m, n, N_H)
    emb = randn(m, n, N_H, grad=True)
    gm = randn(m, n)

    def einsums():
        o1 = torch.einsum("nf,mhf->mnh", ens.x, w1)
        o2 = torch.einsum("mnf,mhf->mnh", a1, w2)
        torch.autograd.grad([o1, o2], [w1, a1, w2], [g1, g2])

    def affinities():
        msg = torch.stack([node_affinity(ens.raw_ell, e) for e in emb])
        torch.autograd.grad(msg, emb, gm)

    parts = {name: device_ms(fn, iters=5)[0] for name, fn in [
        ("K1 x4 (d 600 and 300, forward and transposed)",
         lambda: (pb.bcsr_matmul(pair.fwd, h1), pb.bcsr_matmul(pair.fwd, h2),
                  pb.bcsr_matmul(pair.bwd, h1), pb.bcsr_matmul(pair.bwd, h2))),
        ("einsums forward + backward", einsums),
        (f"{m} ELL affinities forward + backward", affinities)]}
    parts["rest (elementwise, Adam, padding)"] = dev - sum(parts.values())
    return (f"  tam epoch (photo, BCSR, {m} members): device time {dev:.4f} "
            f"ms against a median of {wall_ms:.3f} ms, busy share "
            f"{dev / wall_ms:.3f}; {ops:.1f} device ops an epoch; parts "
            f"alone (ms, device): {json.dumps(parts)}")


def tam_phase(cuda, k1: dict, k2: dict, later: list):
    """TAM on the photo-shaped graph through ``run_tam_baseline`` (500
    epochs on the block-diagonal route, K1's exact launches), its build,
    epoch time and memory, the card's two routes against each other and
    against the CPU; then the elliptic-shaped graph on ELL. Returns the
    photo block-diagonal tile pair for the kernel phase; appends the
    profiled epoch to ``later``."""
    import math

    import torch

    from ggad_tpu_torch.datasets.splits import tam_split
    from ggad_tpu_torch.datasets.synthetic import photo_bench, synthetic_like
    from ggad_tpu_torch.graph import add_self_loops, from_scipy
    from ggad_tpu_torch.models import tam
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm, pick_tile_rows
    from ggad_tpu_torch.ops.ell_spmm import as_ell_graph
    from ggad_tpu_torch.train import baselines as tb

    t_phase = time.perf_counter()
    ds = photo_bench()
    raw = add_self_loops(from_scipy(ds.adj, device=cuda))
    row, col, _ = raw.host_coo()
    tile_rows = pick_tile_rows(row, col, raw.n_nodes)
    chunk = tam.member_chunk_for(raw, "bcsr", TAM_CUTTING, N_H,
                                 tile_rows=tile_rows)
    n_chunks = -(-TAM_CUTTING // chunk)
    route = tam.tam_route(raw)
    if route != "bcsr":
        raise RuntimeError(f"tam: the photo graph took the {route} route")

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    res = tb.run_tam_baseline(ds, n_h=N_H, cutting=TAM_CUTTING,
                              num_epoch=TAM_EPOCHS, lr=TAM_LR, seed=0,
                              eval_every=1, device=cuda)
    torch.cuda.synchronize()
    n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
    if (n1, n2) != (TAM_K1 * TAM_EPOCHS * n_chunks, 0):
        raise RuntimeError(f"tam: K1 {n1}, K2 {n2} launches; expected K1 "
                           f"{TAM_K1 * TAM_EPOCHS * n_chunks}, K2 0")
    rounds = [r for r in res.history if "round" in r]
    if (len(rounds) != TAM_CUTTING
            or not all(math.isfinite(r["auc"]) for r in res.history)):
        raise RuntimeError(f"tam: bad history {res.history}")
    peak_run = (torch.cuda.max_memory_allocated() - base) / 1e6
    k1["float32"]["paths"]["tam (photo, BCSR)"] = n1
    for rec in (k1["bfloat16"], *k2.values()):
        rec["paths"]["tam (photo, BCSR)"] = 0
    print(f"tam photo (BCSR, tile height {tile_rows}, {TAM_CUTTING} members "
          f"in {n_chunks} chunk(s), n_h {N_H}): run_tam_baseline "
          f"{TAM_EPOCHS} epochs {res.wall_time_s:.3f} s, K1 launches {n1}, "
          f"K2 0, peak device memory {peak_run:.1f} MB above the earlier "
          f"phases'; (round, AUROC, AP) "
          f"{json.dumps([(r['round'], r['auc'], r['ap']) for r in rounds])}; "
          f"final AUROC {res.auc:.6f} AP {res.ap:.6f}")

    # the run's set-up again, part by part (host clock, each part ending
    # in a synchronise), then its epochs alone
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    raw = add_self_loops(from_scipy(ds.adj, device=cuda))
    normal = tam_split(ds.ano_labels, seed=0).normal_label_idx
    lap("graph + I and split")
    raw_ell = as_ell_graph(raw)
    lap("raw flat ELL tables")
    x, params, vals = tam_members(raw, ds, cuda)
    norm = tam.sym_normalize_vals(vals, raw)
    lap("init, cuts, normalisation")
    base = torch.cuda.memory_allocated()
    pair = tam.blockdiag_pair(raw, norm, tile_rows)
    lap("block-diagonal pair")
    held = (torch.cuda.memory_allocated() - base) / 1e6
    store = sum(t.values.numel() * 4 for t in (pair.fwd, pair.bwd)) / 1e6
    csr = sum((t.row_ptr.numel() + t.col.numel() + t.val.numel()) * 4
              for t in (pair.fwd, pair.bwd)) / 1e6
    ens = tam.TAMEnsemble(tam.blockdiag_aggregate(pair, ds.n_nodes), x,
                          raw_ell, torch.as_tensor(normal, device=cuda),
                          params, TAM_LR)
    ens.step()
    lap("first epoch")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bcsr_spmm.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TAM_TIMED + 1)]
    ev[0].record()
    for i in range(TAM_TIMED):
        ens.step()
        ev[i + 1].record()
    torch.cuda.synchronize()
    if bcsr_spmm.launches != TAM_K1 * TAM_TIMED:
        raise RuntimeError(f"tam epochs: K1 {bcsr_spmm.launches} launches "
                           f"in {TAM_TIMED} epochs")
    epochs = [ev[i].elapsed_time(ev[i + 1]) for i in range(TAM_TIMED)]
    epoch_ms = statistics.median(epochs)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    print(f"  block-diagonal pair: {pair.fwd.n_tiles} tiles an orientation "
          f"({pair.fwd.n_rows}x{pair.fwd.n_cols}, nnz {pair.fwd.col.numel()}"
          f" / {pair.bwd.col.numel()}); device memory {held:.1f} MB (tile "
          f"stores {store:.1f}, compressed rows {csr:.1f})")
    print(f"  the run's set-up again by part (s, host clock): "
          f"{json.dumps(parts)}")
    print(f"  epoch ms (CUDA events, {TAM_TIMED} after a warm-up) "
          f"{[round(e, 3) for e in epochs]} (median {epoch_ms:.3f}); peak "
          f"device memory in an epoch {peak:.1f} MB above what is held")
    later.append(partial(tam_epoch_line, ens, pair, ds.n_nodes, epoch_ms))

    kw = dict(n_h=N_H, cutting=TAM_CUTTING, lr=TAM_LR,
              num_epoch=TAM_ROUTE_EPOCHS, val_stack=vals,
              member_params=params, loss_record=range(TAM_ROUTE_EPOCHS))
    t0 = time.perf_counter()
    by_route = {impl: tam.run_tam(raw, ds.features, normal, impl=impl, **kw)
                for impl in ("bcsr", "ell")}
    torch.cuda.synchronize()
    diff = tam_compare(by_route["bcsr"], by_route["ell"], "tam BCSR vs ELL")
    print(f"  card BCSR vs card ELL, {TAM_ROUTE_EPOCHS} epochs from the same "
          f"cut values and weights: max|d| {json.dumps(diff)} (tol "
          f"{LOSS_TOL}·(1 + |ELL|)); {time.perf_counter() - t0:.3f} s")

    m = TAM_CPU_MEMBERS
    kw = dict(n_h=N_H, cutting=m, lr=TAM_LR, num_epoch=TAM_CPU_EPOCHS,
              loss_record=range(TAM_CPU_EPOCHS), val_stack=vals[:m].cpu(),
              member_params={k: v[:m] for k, v in params.items()})
    t0 = time.perf_counter()
    card = tam.run_tam(raw, ds.features, normal, impl="bcsr", **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = tam.run_tam(add_self_loops(from_scipy(ds.adj, device="cpu")),
                      ds.features, normal, impl="ell", **kw)
    diff = tam_compare(card, cpu, "tam card vs CPU")
    last = TAM_CPU_EPOCHS - 1
    print(f"  card BCSR vs CPU ELL, {m} members, {TAM_CPU_EPOCHS} epochs: "
          f"max|d| {json.dumps(diff)} (tol {LOSS_TOL}·(1 + |CPU|)); last "
          f"losses card {card.loss_history[last].tolist()} cpu "
          f"{cpu.loss_history[last].tolist()}; card {t1 - t0:.3f} s, CPU "
          f"{time.perf_counter() - t1:.3f} s")

    ell = synthetic_like("elliptic")
    route = tam.tam_route(add_self_loops(from_scipy(ell.adj, device=cuda)))
    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    res = tb.run_tam_baseline(ell, n_h=N_H, cutting=TAM_CUTTING,
                              num_epoch=TAM_ELL_EPOCHS, lr=TAM_LR, seed=0,
                              eval_every=1, device=cuda)
    torch.cuda.synchronize()
    if route != "ell" or bcsr_spmm.launches or bcsr_sddmm_colsum.launches:
        raise RuntimeError(f"tam on the elliptic shape: route {route}, K1 "
                           f"{bcsr_spmm.launches}, K2 "
                           f"{bcsr_sddmm_colsum.launches}")
    if not all(math.isfinite(r["auc"]) for r in res.history):
        raise RuntimeError(f"tam (ELL): bad history {res.history}")
    for rec in (*k1.values(), *k2.values()):
        rec["paths"]["tam (elliptic, ELL)"] = 0
    print(f"tam on the elliptic-shaped graph under auto: route {route}, "
          f"{TAM_ELL_EPOCHS} epochs {res.wall_time_s:.3f} s, K1 0, K2 0; "
          f"final AUROC {res.auc:.6f} AP {res.ap:.6f}")
    print(f"tam phase: {time.perf_counter() - t_phase:.1f} s")
    return pair


def tam_kernel_checks(pair, k1: dict) -> None:
    """K1 f32 on TAM's block-diagonal tile pair, forward and transposed, at
    gcn1's and gcn2's widths: held against its plain version and timed
    against its bound, its plain version and ``torch.sparse.mm``."""
    import torch

    gen = torch.Generator(pair.fwd.values.device).manual_seed(4)
    recs = {}
    for d in (2 * N_H, N_H):
        h = torch.randn(pair.fwd.n_cols, d, device=pair.fwd.values.device,
                        generator=gen)
        for side, tiles in (("forward", pair.fwd), ("transposed", pair.bwd)):
            print(f"K1 TAM block-diagonal {side} f32: T={tiles.n_tiles} "
                  f"tr={tiles.tile_height} {tiles.n_rows}x{tiles.n_cols} "
                  f"d={d}")
            rec = check_k1(tiles, h, "float32", timed=True)
            recs[f"{side} d{d}"] = {key: rec[key] for key in K1_KEEP}
            print("  " + json.dumps(recs[f"{side} d{d}"]))
        del h
    k1["float32"]["tam_blockdiag"] = recs
    k1["float32"]["max_abs_err"] = max(
        k1["float32"]["max_abs_err"],
        *(r["max_abs_err"] for r in recs.values()))


def halo_steps(tr, init, noises, timed: bool = False):
    """``init`` loaded, a fresh Adam, one step a noise draw, then one
    evaluation: (losses a step, the six fields; scores; step ms by CUDA
    events when ``timed``)."""
    import torch

    tr.model.load_state_dict(init)
    tr.optimizer = tr.make_optimizer()
    out, ev = [], []
    for noise in noises:
        if timed:
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
        tr.optimizer.zero_grad(set_to_none=True)
        losses = tr.compute_losses(noise)
        losses.total.backward()
        tr.optimizer.step()
        out.append(torch.stack([t.detach() for t in losses]))
    if timed:
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        torch.cuda.synchronize()
    losses = [[float(x) for x in t] for t in out]
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    return losses, tr.eval_scores(), ms


def halo_step_fn(tr, noise):
    def step():
        tr.optimizer.zero_grad(set_to_none=True)
        tr.compute_losses(noise).total.backward()
        tr.optimizer.step()
    return step


def assert_close_rel(got, ref, tol: float, what: str) -> float:
    """|got − ref| ≤ tol·(1 + |ref|) elementwise; returns max |got − ref|."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        raise RuntimeError(f"{what}: shape {got.shape} vs {ref.shape} or "
                           f"non-finite values")
    diff = np.abs(got - ref)
    if not np.all(diff <= tol * (1 + np.abs(ref))):
        raise RuntimeError(f"{what}: max |d| {diff.max():.3g} over "
                           f"{tol}·(1 + |ref|)")
    return float(diff.max())


def halo_layout_lines(tr) -> list:
    """The plan's widths and wire volume, and each shard's tile sets."""
    from ggad_tpu_torch.parallel.spmm_shard import halo_comm_stats

    setup = tr._sharded
    plan, t, sub = setup.plan, setup.tiles, setup.aff_sub
    stats = {d: halo_comm_stats(plan, d) for d in (tr.dataset.feat_dim, N_H)}
    lines = [f"  plan: rows_per_shard {plan.rows_per_shard}, E_shard "
             f"{setup.part.e_shard}, boundary B {plan.boundary}, wire rows "
             f"{stats[N_H]['wire_rows']} a shard (buffer {plan.buf_width}, "
             f"round widths {list(plan.dist_widths) or 'one all-to-all'}); "
             f"SpMM halo bytes a shard {stats[tr.dataset.feat_dim]['spmm_halo_bytes']} "
             f"at d {tr.dataset.feat_dim}, {stats[N_H]['spmm_halo_bytes']} at "
             f"d {N_H} (all-gather {stats[N_H]['allgather_bytes']})"]
    if t is not None:
        lines.append(
            f"  tiles (tile height {t.loc[0].tile_height}): local "
            f"{[b.n_tiles for b in t.loc]} / transposed "
            f"{[b.n_tiles for b in t.locT]}, remote {[b.n_tiles for b in t.fwd]}"
            f" / transposed {[b.n_tiles for b in t.bwd]}; r_row_pad x "
            f"r_col_pad {t.r_row_pad} x {t.r_col_pad}, w_row_pad x w_col_pad "
            f"{t.w_row_pad} x {t.w_col_pad}; margin subset U {sub.n_uniq}, "
            f"[R x U] {[b.n_tiles for b in sub.t_fwd]} / [U x R] "
            f"{[b.n_tiles for b in sub.t_bwd]} tiles")
    return lines


def halo_rect_checks(tr, dtype: str, k1: dict, k2: dict) -> None:
    """Each shard's rect sets held against their plain versions at the
    main path's widths (K1 forward sets at the feature width for Â·x and
    at n_h; transposed sets at n_h; the margin subset's K2 and its two
    K1); shard 0's timed against the bound, the plain version and
    ``torch.sparse.mm`` (``sampled_addmm`` for K2)."""
    import torch

    from ggad_tpu_torch.ops.sddmm import l2_normalize_rows

    setup = tr._sharded
    t, sub, plan = setup.tiles, setup.aff_sub, setup.plan
    R, W, F = plan.rows_per_shard, plan.buf_width, tr.dataset.feat_dim
    cuda = tr.device
    gen = torch.Generator(cuda).manual_seed(5)

    def rand(n, d):
        return torch.randn(n, d, device=cuda, generator=gen)

    keep = K1_KEEP
    recs, errs = {}, []
    for d in (F, N_H):
        h, buf, g = rand(R, d), rand(W, d), rand(R, d)
        sets = [("local", t.loc, h, R), ("remote", t.fwd, buf, R)]
        if d == N_H:
            sets += [("local transposed", t.locT, g, R),
                     ("remote transposed", t.bwd, g, W)]
        for name, per_shard, x, n_out in sets:
            for i, tiles in enumerate(per_shard):
                rec = check_k1(tiles, x, dtype, n_out=n_out, timed=i == 0)
                errs.append(rec["max_abs_err"])
                if i == 0:
                    recs[f"{name} d{d}"] = {k: rec[k] for k in keep}
                    if name == "remote" and dtype == "float32":
                        recs[f"{name} d{d}"]["pace"] = walk_pace(tiles, x,
                                                                 n_out)
                    print(f"K1 halo {name} {dtype} shard 0: T={tiles.n_tiles}"
                          f" {tiles.n_rows}x{tiles.n_cols} d={d}: "
                          f"{json.dumps(recs[f'{name} d{d}'])}")
    U = sub.n_uniq
    e = l2_normalize_rows(rand(R, N_H))
    tgt = l2_normalize_rows(rand(U, N_H))
    gu = rand(U, N_H)
    k2_errs = []
    for i in range(len(sub.t_bwd)):
        timed = i == 0
        r2 = check_k2(sub.t_bwd[i], tgt, e, dtype, timed=timed)
        rb = check_k1(sub.t_bwd[i], e, dtype, n_out=U, timed=timed)
        rf = check_k1(sub.t_fwd[i], gu, dtype, n_out=R, timed=timed)
        k2_errs.append(r2["max_abs_err"])
        errs += [rb["max_abs_err"], rf["max_abs_err"]]
        if timed:
            recs["subset [U x R] (K2 backward)"] = {k: rb[k] for k in keep}
            recs["subset [R x U] (K2 backward)"] = {k: rf[k] for k in keep}
            k2[dtype]["halo_rect"] = {k: r2[k] for k in K2_KEEP}
            print(f"K2 halo subset {dtype} shard 0: T={sub.t_bwd[0].n_tiles}"
                  f" {sub.t_bwd[0].n_rows}x{sub.t_bwd[0].n_cols} U={U} "
                  f"d={N_H}: {json.dumps(k2[dtype]['halo_rect'])}")
            print(f"  its two K1 [U x R] / [R x U]: "
                  f"{json.dumps(recs['subset [U x R] (K2 backward)'])} / "
                  f"{json.dumps(recs['subset [R x U] (K2 backward)'])}")
    k1[dtype]["halo_rect"] = recs
    k1[dtype]["max_abs_err"] = max(k1[dtype]["max_abs_err"], *errs)
    k2[dtype]["max_abs_err"] = max(k2[dtype]["max_abs_err"], *k2_errs)
    print(f"halo rect sets {dtype}: {len(errs)} K1 and {len(k2_errs)} K2 "
          f"checks on {len(t.loc)} shards, max|d| K1 {max(errs):.3g}, K2 "
          f"{max(k2_errs):.3g}")


@contextlib.contextmanager
def nccl_world_of_one():
    """An NCCL process group of world size 1 (a TCPStore on localhost,
    rank 0), destroyed on leaving: the one NCCL run a single card allows."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def halo_nccl_check(ds, cuda, init, noises) -> None:
    """The ``"dist"`` communicator on NCCL at world size 1 (a TCPStore
    on localhost, rank 0) against the local one at D = 1: the one NCCL
    run a single card allows."""
    from ggad_tpu_torch.parallel.mesh import make_mesh
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    with nccl_world_of_one():
        res = {}
        for comm in ("dist", "local"):
            tr = FullBatchTrainer(
                ds, embedding_dim=N_H, noise_mean=0.02, noise_std=0.01,
                mesh=make_mesh(1, comm=comm, device=cuda), device=cuda)
            res[comm] = halo_steps(tr, init, noises)[:2]
            del tr
    d1 = assert_close_rel(res["dist"][0], res["local"][0], LOSS_TOL,
                          "NCCL D1 losses")
    d2 = assert_close_rel(res["dist"][1], res["local"][1], SCORE_TOL,
                          "NCCL D1 scores")
    print(f"halo NCCL world size 1 vs local D1, {len(noises)} steps: "
          f"losses max|d| {d1:.3g}, scores max|d| {d2:.3g}. NCCL at D > 1 "
          f"is unverified: this machine has one card")


def halo_partitioned_run(ds, cuda, init, noises, k1, k2, later,
                         counts) -> None:
    """The photo shape renumbered by ``reorder_lp`` (contiguous row
    blocks a shard: a boundary below the shard's rows, the order users
    train the halo in) over ``HALO_D`` shards on one wire in f32: the
    three wires' widths, exact K1/K2 counts, losses and scores against
    the single-device trainer on the same order."""
    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.partition import cut_fraction, reorder_lp
    from ggad_tpu_torch.graph import from_scipy
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.ops.normalize import normalize_adj_reference
    from ggad_tpu_torch.parallel.spmm_shard import (
        build_halo_plan,
        halo_comm_stats,
        partition_edges,
    )
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lp = reorder_lp(ds, HALO_D)
    t_lp = time.perf_counter() - t0
    blocks = np.arange(ds.n_nodes) // -(-ds.n_nodes // HALO_D)
    adj, _ = normalize_adj_reference(from_scipy(lp.adj, device="cpu"))
    part = partition_edges(adj, HALO_D)
    wires = {s: build_halo_plan(part, s) for s in ("dense", "ring", "sched")}
    print(f"halo photo D{HALO_D} after reorder_lp ({t_lp:.3f} s on the "
          f"host): cut fraction {cut_fraction(ds.adj, blocks):.4f} -> "
          f"{cut_fraction(lp.adj, blocks):.4f}; boundary B "
          f"{wires['dense'].boundary} of {part.rows_per_shard} rows; wire "
          f"rows a shard (buffer, round widths): " + "; ".join(
              f"{s} {halo_comm_stats(p, N_H)['wire_rows']} ({p.buf_width}, "
              f"{list(p.dist_widths) or 'one all-to-all'})"
              for s, p in wires.items()))
    kw = dict(embedding_dim=N_H, noise_mean=0.02, noise_std=0.01)
    ref = FullBatchTrainer(lp, device=cuda, **kw)
    r = halo_steps(ref, init, noises, timed=True)
    del ref
    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    tr = FullBatchTrainer(lp, mesh=HALO_D, dist_schedule=HALO_LP_SCHEDULE,
                          device=cuda, **kw)
    h = halo_steps(tr, init, noises, timed=True)
    torch.cuda.synchronize()
    n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
    if tr.route != "bcsr" or (n1, n2) != counts:
        raise RuntimeError(f"halo reorder_lp: route {tr.route}, K1 {n1}, K2 "
                           f"{n2}; expected bcsr, {counts}")
    path = f"halo photo D{HALO_D} reorder_lp {HALO_LP_SCHEDULE}"
    k1["float32"]["paths"][path] = n1
    k2["float32"]["paths"][path] = n2
    d = (assert_close_rel(h[0], r[0], LOSS_TOL, "reorder_lp halo losses"),
         assert_close_rel(h[1], r[1], SCORE_TOL, "reorder_lp halo scores"))
    print(f"halo photo D{HALO_D} reorder_lp {HALO_LP_SCHEDULE} float32: K1 "
          f"{n1}, K2 {n2} launches; step ms median "
          f"{statistics.median(h[2]):.3f} (single-device "
          f"{statistics.median(r[2]):.3f}); vs single-device losses / "
          f"scores max|d| {d[0]:.3g} / {d[1]:.3g} (tol {LOSS_TOL}·(1 + "
          f"|ref|))")
    for line in halo_layout_lines(tr):
        print(line)
    later.append(partial(busy_line,
                         f"halo step D{HALO_D} reorder_lp {HALO_LP_SCHEDULE}",
                         halo_step_fn(tr, noises[0]),
                         statistics.median(h[2]), HALO_STEPS))
    del tr


def halo_phase(cuda, k1: dict, k2: dict, later: list) -> dict:
    """The halo path: ``FullBatchTrainer(mesh=4)`` on the photo shape at
    n_h 300 on the local communicator, each wire in f32 and the dense one
    in bf16, from one init and one noise sequence: exact K1/K2 counts,
    losses and scores against the single-device trainer, the wires
    against each other, bf16 against f32, the card against the CPU; the
    elliptic shape on the ELL route; the NCCL communicator at world size
    1. Returns the dense wire's trainers by dtype, whose rect sets
    ``halo_rect_checks`` times after the timed phases."""
    import torch

    import numpy as np

    from ggad_tpu_torch.datasets.synthetic import photo_bench, synthetic_like
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    t_phase = time.perf_counter()
    ds = photo_bench()
    kw = dict(embedding_dim=N_H, noise_mean=0.02, noise_std=0.01)
    ref = FullBatchTrainer(ds, device=cuda, **kw)
    init = ref.init()
    gen = torch.Generator(cuda).manual_seed(7)
    noises = [ref.draw_noise(gen) for _ in range(HALO_STEPS)]
    ref_losses, ref_scores, ref_ms = halo_steps(ref, init, noises,
                                                timed=True)
    print(f"halo reference: single-device photo f32 ({ref.route}), "
          f"{HALO_STEPS} steps, step ms {[round(x, 3) for x in ref_ms]} "
          f"(median {statistics.median(ref_ms):.3f})")
    del ref
    kept, runs = {}, {}
    n_k1 = HALO_D * (HALO_K1["prepare"] + HALO_STEPS * HALO_K1["step"]
                     + HALO_K1["eval"])
    n_k2 = HALO_D * HALO_STEPS * HALO_K2_STEP
    for schedule, dtype in HALO_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
        t0 = time.perf_counter()
        tr = FullBatchTrainer(ds, spmm_dtype=dtype, mesh=HALO_D,
                              dist_schedule=schedule, device=cuda, **kw)
        torch.cuda.synchronize()
        prep = time.perf_counter() - t0
        held = (torch.cuda.memory_allocated() - base) / 1e6
        losses, scores, ms = halo_steps(tr, init, noises, timed=True)
        torch.cuda.synchronize()
        n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
        if tr.route != "bcsr" or (n1, n2) != (n_k1, n_k2):
            raise RuntimeError(f"halo {schedule} {dtype}: route {tr.route}, "
                               f"K1 {n1}, K2 {n2}; expected bcsr, {n_k1}, "
                               f"{n_k2}")
        path = f"halo photo D{HALO_D} {schedule}"
        k1[dtype]["paths"][path] = n1
        k2[dtype]["paths"][path] = n2
        runs[schedule, dtype] = (losses, scores)
        print(f"halo photo D{HALO_D} {schedule} {dtype}: prepare {prep:.3f} "
              f"s, device memory held {held:.1f} MB; K1 {n1}, K2 {n2} "
              f"launches ({HALO_STEPS} steps + an evaluation); step ms "
              f"{[round(x, 3) for x in ms]} (median "
              f"{statistics.median(ms):.3f}; single-device "
              f"{statistics.median(ref_ms):.3f}); totals "
              f"{[round(x[0], 6) for x in losses]}")
        for line in halo_layout_lines(tr):
            print(line)
        later.append(partial(busy_line,
                             f"halo step D{HALO_D} {schedule} {dtype}",
                             halo_step_fn(tr, noises[0]),
                             statistics.median(ms), HALO_STEPS))
        if schedule == "dense":
            kept[dtype] = tr
        del tr
    dense = runs["dense", "float32"]
    d_ref = (assert_close_rel(dense[0], ref_losses, LOSS_TOL,
                              "halo vs single-device losses"),
             assert_close_rel(dense[1], ref_scores, SCORE_TOL,
                              "halo vs single-device scores"))
    d_wire = max(max(assert_close_rel(runs[s, "float32"][0], dense[0],
                                      WIRE_TOL, f"{s} vs dense losses"),
                     assert_close_rel(runs[s, "float32"][1], dense[1],
                                      WIRE_TOL, f"{s} vs dense scores"))
                 for s in ("ring", "sched"))
    bf = runs["dense", "bfloat16"]
    d_bf = assert_close_rel(bf[0], dense[0], BF16_TOL, "bf16 vs f32 losses")
    bf_scores = abs(np.asarray(bf[1], np.float64) - dense[1])
    print(f"halo checks: f32 vs single-device losses / scores max|d| "
          f"{d_ref[0]:.3g} / {d_ref[1]:.3g} (tol {LOSS_TOL}·(1 + |ref|)); "
          f"ring and sched vs dense {d_wire:.3g} (tol {WIRE_TOL}); bf16 vs "
          f"f32 losses {d_bf:.3g} (tol {BF16_TOL}·(1 + |f32|)); bf16 vs "
          f"f32 scores, a reading: max|d| {bf_scores.max():.3g}, max "
          f"|d|/(1 + |f32|) "
          f"{(bf_scores / (1 + np.abs(dense[1]))).max():.3g}")

    # each dtype on the card against the same halo on the CPU (the plain
    # versions: bf16 tiles and operands there too): the losses of the
    # steps from one init; the f32 scores after them, the bf16 scores at
    # the card's weights (Adam's first steps move each weight by ±lr
    # whatever its gradient's size, so a bf16 gradient near 0 that
    # changes sign parts the two runs' weights)
    cpu_init = {k: v.cpu() for k, v in init.items()}
    cpu_noises = [n.cpu() for n in noises[:HALO_CPU_STEPS]]
    for dtype, tr in kept.items():
        cpu = FullBatchTrainer(ds, spmm_dtype=dtype, mesh=HALO_D,
                               device="cpu", **kw)
        got = halo_steps(cpu, cpu_init, cpu_noises)
        card = halo_steps(tr, init, noises[:HALO_CPU_STEPS])
        d_loss = assert_close_rel(card[0], got[0], LOSS_TOL,
                                  f"halo {dtype} card vs CPU losses")
        if dtype == "float32":
            d_score = assert_close_rel(card[1], got[1], SCORE_TOL,
                                       f"halo {dtype} card vs CPU scores")
            note = f"scores {d_score:.3g} (tol {SCORE_TOL}·(1 + |CPU|))"
        else:
            at_card = cpu.eval_scores({k: v.cpu()
                                       for k, v in tr.params().items()})
            d_score = assert_close_rel(card[1], at_card, BF16_SCORE_TOL,
                                       f"halo {dtype} card vs CPU scores "
                                       f"at the card's weights")
            # the single-device bf16 trainer at the same weights: the
            # same card-vs-CPU spread without the halo
            single = [FullBatchTrainer(ds, spmm_dtype=dtype, device=dev,
                                       **kw).eval_scores(
                          {k: v.to(dev) for k, v in tr.params().items()})
                      for dev in (cuda, "cpu")]
            rel = lambda a, b: float((np.abs(a - b) / (1 + np.abs(b))).max())
            note = (f"scores at the card's weights max|d| {d_score:.3g}, "
                    f"max|d|/(1 + |CPU|) {rel(card[1], at_card):.3g} (tol "
                    f"{BF16_SCORE_TOL}); readings: after each side's own "
                    f"steps {rel(card[1], got[1]):.3g}, the single-device "
                    f"bf16 trainer at the card's weights "
                    f"{rel(*single):.3g}")
        del cpu
        print(f"halo {dtype} card vs CPU (the plain versions), "
              f"{HALO_CPU_STEPS} steps + an evaluation: losses max|d| "
              f"{d_loss:.3g} (tol {LOSS_TOL}·(1 + |CPU|)); {note}")

    halo_partitioned_run(ds, cuda, init, noises, k1, k2, later, (n_k1, n_k2))


    # the elliptic shape: the ELL route, no kernel of ours
    gc.collect()
    torch.cuda.empty_cache()
    ell = synthetic_like("elliptic")
    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    ref = FullBatchTrainer(ell, device=cuda, **kw)
    e_init = ref.init()
    e_noises = [ref.draw_noise(gen) for _ in range(HALO_ELL_STEPS)]
    r = halo_steps(ref, e_init, e_noises, timed=True)
    del ref
    t0 = time.perf_counter()
    tr = FullBatchTrainer(ell, mesh=HALO_D, device=cuda, **kw)
    prep = time.perf_counter() - t0
    h = halo_steps(tr, e_init, e_noises, timed=True)
    n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
    if tr.route != "ell" or (n1, n2) != (0, 0):
        raise RuntimeError(f"halo elliptic: route {tr.route}, K1 {n1}, K2 "
                           f"{n2}; expected ell, 0, 0")
    for rec in (*k1.values(), *k2.values()):
        rec["paths"][f"halo elliptic D{HALO_D} (ELL)"] = 0
    d_e = (assert_close_rel(h[0], r[0], LOSS_TOL, "ELL halo losses"),
           assert_close_rel(h[1], r[1], SCORE_TOL, "ELL halo scores"))
    print(f"halo elliptic D{HALO_D} (ELL, {ell.n_nodes} nodes): prepare "
          f"{prep:.3f} s; K1 = K2 = 0; step ms median "
          f"{statistics.median(h[2]):.3f} (single-device "
          f"{statistics.median(r[2]):.3f}); vs single-device losses / "
          f"scores max|d| {d_e[0]:.3g} / {d_e[1]:.3g}")
    later.append(partial(busy_line, f"halo step D{HALO_D} elliptic (ELL)",
                         halo_step_fn(tr, e_noises[0]),
                         statistics.median(h[2]), HALO_ELL_STEPS))
    del tr

    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0
    halo_nccl_check(ds, cuda, init, noises[:HALO_NCCL_STEPS])
    n1, n2 = bcsr_spmm.launches, bcsr_sddmm_colsum.launches
    # two runs ("dist" and "local") of one shard each
    e1 = 2 * (HALO_K1["prepare"] + HALO_NCCL_STEPS * HALO_K1["step"]
              + HALO_K1["eval"])
    e2 = 2 * HALO_NCCL_STEPS * HALO_K2_STEP
    if (n1, n2) != (e1, e2):
        raise RuntimeError(f"halo NCCL D1: K1 {n1}, K2 {n2}; expected {e1}, "
                           f"{e2}")
    print(f"halo NCCL D1 vs local D1: K1 {n1}, K2 {n2} launches (expected)")
    k1["float32"]["paths"]["halo photo D1 NCCL vs local"] = n1
    k2["float32"]["paths"]["halo photo D1 NCCL vs local"] = n2
    print(f"halo phase {time.perf_counter() - t_phase:.1f} s")
    return kept


def step_ms(step, args: list) -> list:
    """CUDA-event milliseconds of ``step(*a)`` for each ``a`` of ``args``
    in turn."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(args) + 1)]
    ev[0].record()
    for i, a in enumerate(args):
        step(*a)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(args))]


def held_and_peak(fn):
    """``fn()``'s result, the device memory it leaves held and the peak
    above the start while it ran, both in MB."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (out, (torch.cuda.memory_allocated() - base) / 1e6,
            (torch.cuda.max_memory_allocated() - base) / 1e6)


def reset_launches() -> None:
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm

    bcsr_spmm.launches = bcsr_sddmm_colsum.launches = 0


def read_launches() -> tuple:
    import torch

    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm

    torch.cuda.synchronize()
    return bcsr_spmm.launches, bcsr_sddmm_colsum.launches


def record_zero_launches(k1: dict, k2: dict, path: str) -> None:
    """Fail unless K1 and K2 launched no time since ``reset_launches``;
    record the path's 0 launches."""
    n1, n2 = read_launches()
    if n1 or n2:
        raise RuntimeError(f"{path}: K1 {n1}, K2 {n2} launches; expected 0")
    for rec in (*k1.values(), *k2.values()):
        rec["paths"][path] = 0


def dp_phase(cuda, k1: dict, k2: dict, later: list, ds, adj, split) -> None:
    """Phase 6c: ``MiniBatchTrainer(mesh=DP_D)`` on phase 6's DGraph-shaped
    graph beside the single-device trainer (same seed-0 weights, batches
    and draws): held memory, losses, scores, step medians, one epoch; K1
    = K2 = 0; then NCCL at world size 1 against the local mesh at D 1."""
    import numpy as np
    import torch

    from ggad_tpu_torch.parallel.mesh import make_mesh
    from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

    t_phase = time.perf_counter()
    idx_train, idx_valid, idx_test, labels, idx_anom = split
    inputs = dict(adj=adj, features=ds.features, labels=labels,
                  idx_train=idx_train, idx_anomaly=idx_anom,
                  idx_valid=idx_valid, idx_test=idx_test)
    shape = dict(emb_dim=64, fanout1=16, fanout2=8, batch_size=150,
                 n_anom_per_batch=50, num_batches=DP_EPOCH_BATCHES,
                 eval_batch=1024)
    path = f"minibatch DP D{DP_D} (DGraph)"
    reset_launches()
    trainers, held = {}, {}
    for d in (None, DP_D):
        trainers[d], held[d], _ = held_and_peak(partial(
            MiniBatchTrainer, **inputs, **shape, mesh=d, device=cuda))
    one, dp = trainers[None], trainers[DP_D]
    if not abs(held[DP_D] - held[None]) <= 0.1 * held[None]:
        raise RuntimeError(f"DP D{DP_D} holds {held[DP_D]:.1f} MB against "
                           f"the single-device {held[None]:.1f} MB: the "
                           f"tables are not held once")
    batches = one.draw_batches(np.random.default_rng(4))
    nb, b = batches.shape
    gen = torch.Generator(cuda).manual_seed(4)
    u1 = torch.rand(nb, b, 16, generator=gen, device=cuda)
    u2 = torch.rand(nb, b * 16, 8, generator=gen, device=cuda)
    ue = torch.rand(-(-DP_SCORES // 1024), 1024, 16, generator=gen,
                    device=cuda)
    nodes = np.random.default_rng(5).choice(idx_valid, DP_SCORES,
                                            replace=False)
    losses, scores = {}, {}
    for d, t in trainers.items():
        t.reset()
        losses[d] = [[float(x) for x in t.train_step(batches[i], u1[i],
                                                     u2[i])]
                     for i in range(DP_CHECK_STEPS)]
        t.draws = lambda s: ue
        scores[d] = t.score_nodes(None, nodes)
        t.draws = None
    d_loss = assert_close_rel(losses[DP_D], losses[None], LOSS_TOL,
                              "DP vs single-device losses")
    d_score = assert_close_rel(scores[DP_D], scores[None], DP_SCORE_TOL,
                               "DP vs single-device scores")
    args = [(batches[i % nb], u1[i % nb], u2[i % nb])
            for i in range(3, 3 + DP_STEPS)]
    ms, peak = {}, {}
    for d, t in trainers.items():
        ms[d], _, peak[d] = held_and_peak(partial(step_ms, t.train_step,
                                                  args))
    med = {d: statistics.median(v) for d, v in ms.items()}
    t0 = time.perf_counter()
    last = dp.train_epoch(batches, gen)
    torch.stack(list(last)).tolist()
    epoch_s = time.perf_counter() - t0
    record_zero_launches(k1, k2, path)
    print(f"minibatch DP D{DP_D} (DGraph, local communicator): held "
          f"{held[DP_D]:.1f} MB (single-device {held[None]:.1f} MB: the "
          f"tables once); {DP_CHECK_STEPS} steps vs single-device from the "
          f"same weights, batches and draws: losses max|d| {d_loss:.3g} "
          f"(tol {LOSS_TOL}·(1 + |ref|)), {DP_SCORES} scores max|d| "
          f"{d_score:.3g} (tol {DP_SCORE_TOL}·(1 + |ref|)); step ms median "
          f"{med[DP_D]:.3f} (single-device {med[None]:.3f}; {DP_STEPS} "
          f"after 3 warm-up) {[round(x, 3) for x in ms[DP_D]]}; peak "
          f"{peak[DP_D]:.1f} MB above the held (single-device "
          f"{peak[None]:.1f}); one epoch of {nb} batches (one read) "
          f"{epoch_s:.3f} s; K1 0, K2 0 launches")
    later.append(partial(busy_line, f"minibatch DP D{DP_D} train step",
                         lambda: dp.train_step(batches[0], u1[0], u2[0]),
                         med[DP_D], DP_STEPS))
    later.append(partial(busy_line, "minibatch single-device train step "
                         "(beside DP)",
                         lambda: one.train_step(batches[0], u1[0], u2[0]),
                         med[None], DP_STEPS))

    res = {}
    with nccl_world_of_one():
        for comm in ("dist", "local"):
            t = MiniBatchTrainer(**inputs, **shape, device=cuda,
                                 mesh=make_mesh(1, comm=comm, device=cuda))
            res[comm] = [[float(x) for x in t.train_step(batches[i], u1[i],
                                                         u2[i])]
                         for i in range(DP_NCCL_STEPS)]
            del t
    d_nccl = assert_close_rel(res["dist"], res["local"], NCCL_TOL,
                              "DP NCCL D1 vs local D1 losses")
    print(f"minibatch DP NCCL world size 1 vs local D1, {DP_NCCL_STEPS} "
          f"steps: losses max|d| {d_nccl:.3g} (tol {NCCL_TOL}·(1 + |ref|)); "
          f"phase {time.perf_counter() - t_phase:.1f} s")


def gspmd_steps(setup, mesh, params: dict, noises: list,
                sharded=frozenset()):
    """Timed steps of ``make_sharded_train_step`` from ``params``: (the
    losses, the step ms, a step function for the profiler)."""
    import torch

    from ggad_tpu_torch.parallel.full_batch import make_sharded_train_step

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    step = make_sharded_train_step(
        setup, torch.optim.Adam(leaves.values(), lr=1e-3), mesh,
        sharded=sharded)
    out = []
    ms = step_ms(lambda n: out.append(step(leaves, n)),
                 [(n,) for n in noises])
    return ([float(x.total) for x in out], ms,
            lambda: step(leaves, noises[0]))


def gspmd_phase(cuda, k1: dict, k2: dict, later: list) -> None:
    """Phase 8c: the GSPMD trainer, 2-D tensor parallelism, the entry
    points and the CLI's multi-device options on the card."""
    import numpy as np
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.entry import dryrun_multichip, entry
    from ggad_tpu_torch.parallel.full_batch import (
        prepare_gspmd,
        shard_params_2d,
        tp_sharded,
    )
    from ggad_tpu_torch.parallel.mesh import make_mesh
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    t_phase = time.perf_counter()
    ds = photo_bench()
    kw = dict(embedding_dim=N_H, noise_mean=0.02, noise_std=0.01)
    refs = {}
    for impl in ("coo", "bcsr"):
        ref = FullBatchTrainer(ds, spmm_impl=impl, device=cuda, **kw)
        if impl == "coo":
            init = ref.init()
            gen = torch.Generator(cuda).manual_seed(9)
            noises = [ref.draw_noise(gen) for _ in range(GSPMD_STEPS)]
            first = halo_steps(ref, init, noises[:1])
        refs[impl] = halo_steps(ref, init, noises, timed=True)
        refs[impl] += (ref.params(),)
        del ref
    path = f"gspmd photo D{GSPMD_D}"
    reset_launches()
    t0 = time.perf_counter()
    tr, held, _ = held_and_peak(partial(
        FullBatchTrainer, ds, mesh=GSPMD_D, dist_impl="gspmd", device=cuda,
        **kw))
    prep = time.perf_counter() - t0
    after_one = np.abs(halo_steps(tr, init, noises[:1])[1]
                       - np.asarray(first[1], np.float64)).max()
    (losses, scores, ms), _, peak = held_and_peak(
        partial(halo_steps, tr, init, noises, timed=True))
    if tr.route != "coo":
        raise RuntimeError(f"GSPMD route {tr.route}, expected coo")
    d = (assert_close_rel(losses, refs["coo"][0], LOSS_TOL,
                          "GSPMD vs single-device COO losses"),
         assert_close_rel(tr.eval_scores(refs["coo"][3]), refs["coo"][1],
                          SCORE_TOL, "GSPMD vs single-device COO scores at "
                          "its weights"))
    record_zero_launches(k1, k2, path)
    # readings: after each side's own steps (Adam's first steps move a
    # weight by ±lr whatever the size of its gradient, so a near-0
    # gradient whose sign rounding decides parts the runs), and the same
    # spread between the single-device trainer's own two routes
    own = np.abs(np.asarray(scores, np.float64) - refs["coo"][1]).max()
    routes = np.abs(np.asarray(refs["bcsr"][1], np.float64)
                    - refs["coo"][1]).max()
    med = statistics.median(ms)
    print(f"GSPMD photo D{GSPMD_D} f32 (all-gather layout, local "
          f"communicator): prepare {prep:.3f} s, held {held:.1f} MB, peak "
          f"{peak:.1f} MB above it; K1 0, K2 0 launches ({GSPMD_STEPS} "
          f"steps + an evaluation); step ms {[round(x, 3) for x in ms]} "
          f"(median {med:.3f}; single-device COO "
          f"{statistics.median(refs['coo'][2]):.3f}, BCSR "
          f"{statistics.median(refs['bcsr'][2]):.3f}); vs single-device "
          f"COO: {GSPMD_STEPS} steps' losses max|d| {d[0]:.3g}, scores at "
          f"its weights {d[1]:.3g} (tol {LOSS_TOL}·(1 + |ref|)); readings: "
          f"scores after each side's own step {after_one:.3g}, own "
          f"{GSPMD_STEPS} steps {own:.3g}, and single-device BCSR vs COO "
          f"after them {routes:.3g}")
    later.append(partial(busy_line, f"GSPMD step D{GSPMD_D}",
                         halo_step_fn(tr, noises[0]), med, GSPMD_STEPS))
    del tr

    # 2-D tensor parallelism against the 1-D step at the same D
    runs = {}
    for name, mesh in (
            ("1-D", make_mesh(GSPMD_D, device=cuda)),
            ("2-D", make_mesh(GSPMD_D, device=cuda,
                              axis_names=("nodes", "model"),
                              shape=TP_SHAPE))):
        reset_launches()
        params, sharded = init, frozenset()
        if name == "2-D":
            sharded = frozenset(k for k, v in init.items()
                                if tp_sharded(k, v, TP_SHAPE[1]))
            params = shard_params_2d(init, mesh)
        setup, held, _ = held_and_peak(partial(prepare_gspmd, ds, mesh))
        (tl, tms, fn), _, peak = held_and_peak(partial(
            gspmd_steps, setup, mesh, params, noises[:TP_STEPS], sharded))
        record_zero_launches(k1, k2, f"gspmd photo {name} D{GSPMD_D}")
        runs[name] = (tl, tms, held, peak)
        later.append(partial(busy_line, f"GSPMD {name} step "
                             f"{TP_SHAPE if name == '2-D' else GSPMD_D}",
                             fn, statistics.median(tms), TP_STEPS))
    l1, l2 = runs["1-D"][0], runs["2-D"][0]
    d_tp = max(abs(a - c) / abs(c) for a, c in zip(l2, l1))
    if not d_tp <= TP_TOL:
        raise RuntimeError(f"2-D losses {l2} vs 1-D {l1}: relative "
                           f"{d_tp:.3g} over {TP_TOL}")
    print(f"2-D TP {TP_SHAPE} ('nodes', 'model') photo f32, {TP_STEPS} "
          f"steps: losses {[round(x, 6) for x in l2]} vs 1-D D{GSPMD_D} "
          f"{[round(x, 6) for x in l1]}, max relative |d| {d_tp:.3g} (tol "
          f"{TP_TOL}); step ms median {statistics.median(runs['2-D'][1]):.3f}"
          f" (1-D {statistics.median(runs['1-D'][1]):.3f}); held "
          f"{runs['2-D'][2]:.1f} MB (1-D {runs['1-D'][2]:.1f}), peak above "
          f"it {runs['2-D'][3]:.1f} MB (1-D {runs['1-D'][3]:.1f}); sharded "
          f"over 'model': {sorted(sharded)}")

    # the entry points
    fn, args = entry()
    logits = fn(*args)
    if tuple(logits.shape) != (512, 1) or not torch.isfinite(logits).all():
        raise RuntimeError(f"entry(): logits {tuple(logits.shape)}, finite "
                           f"{bool(torch.isfinite(logits).all())}")
    reset_launches()
    t0 = time.perf_counter()
    out = dryrun_multichip(DRYRUN_D)
    n1, n2 = read_launches()
    legs = {k: (v["k1"], v["k2"]) for k, v in out.items()
            if isinstance(v, dict)}
    expect = (DRYRUN_D * (HALO_K1["prepare"] + HALO_K1["step"]),
              DRYRUN_D * HALO_K2_STEP)
    if legs.pop("halo bcsr sched") != expect or (n1, n2) != expect \
            or any(v != (0, 0) for v in legs.values()):
        raise RuntimeError(f"dryrun_multichip({DRYRUN_D}) launches: K1 {n1}"
                           f", K2 {n2}, by leg {legs}; expected {expect} on "
                           f"the BCSR leg alone")
    dry = f"dryrun_multichip({DRYRUN_D}) halo bcsr sched"
    k1["float32"]["paths"][dry], k2["float32"]["paths"][dry] = n1, n2
    print(f"entry(): logits (512, 1) finite; dryrun_multichip({DRYRUN_D}) "
          f"every assertion held in {time.perf_counter() - t0:.3f} s; the "
          f"halo bcsr leg K1 {n1}, K2 {n2} launches (expected {expect}), "
          f"the other legs 0; losses "
          + json.dumps({k: round(v["loss"] if isinstance(v, dict) else v, 6)
                        for k, v in out.items()}))

    # the CLI's multi-device options on the card, in two processes at once
    cli = [sys.executable, "-m", "ggad_tpu_torch.cli"]
    cmds = {
        "--dp_devices 4": cli + ["--dataset", "dgraphfin",
                                 "--synthetic_scale", "0.01", "--model",
                                 "ggad-minibatch", "--num_epoch", "2",
                                 "--dp_devices", "4"],
        "--mesh_devices 4 --dist_impl gspmd": cli + [
            "--dataset", "photo", "--synthetic_scale", "0.05",
            "--embedding_dim", "64", "--num_epoch", "4", "--eval_every",
            "2", "--mesh_devices", "4", "--dist_impl", "gspmd"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 cwd=os.path.dirname(os.path.abspath(
                                     __file__)))
             for k, c in cmds.items()}
    try:
        done = {k: p.communicate(timeout=300) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"CLI {k}: exit {p.returncode}\n"
                               f"{done[k][1][-3000:]}")
    recs = {k: json.loads(done[k][0].strip().splitlines()[-1]) for k in cmds}
    mb, fb = recs["--dp_devices 4"], recs["--mesh_devices 4 --dist_impl gspmd"]
    if not (np.isfinite(mb["test_auc"]) and np.isfinite(fb["auc"])
            and fb["spmm_route"] == "coo" and fb["n_shards"] == 4):
        raise RuntimeError(f"CLI records {recs}")
    print(f"CLI on the card ({time.perf_counter() - t0:.1f} s, both at "
          f"once): " + json.dumps(recs))
    print(f"multi-device phase (GSPMD, 2-D, entry points, CLI) "
          f"{time.perf_counter() - t_phase:.1f} s")


def amazon_halo_phase(cuda, k1: dict, k2: dict, later: list):
    """Phase 8d: the partitioner's two routes on the elliptic shape, then
    the halo path on the full Amazon shape after a native ``reorder_lp``
    against the single-device trainer. Returns the halo trainer, whose
    rect sets ``amazon_rect_checks`` times after the timed phases, and the
    single-device trainer's tile pair with the feature width, which
    ``amazon_single_checks`` times then."""
    import numpy as np
    import torch

    from ggad_tpu_torch import native
    from ggad_tpu_torch.datasets.partition import (
        cut_fraction,
        multilevel_partition,
        reorder_lp,
    )
    from ggad_tpu_torch.datasets.synthetic import synthetic_like
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    # the multilevel partitioner on the native and the Python route
    ell = synthetic_like("elliptic")
    block = -(-ell.n_nodes // AMAZON_D)
    native.reset_calls()
    t_native = []
    for _ in range(2):          # the first call also pays scipy's warm-up
        t0 = time.perf_counter()
        lab_native = multilevel_partition(ell.adj, AMAZON_D,
                                          exact_block=block)
        t_native.append(time.perf_counter() - t0)
    calls = {k: n for k, n in native.calls.items() if n}
    available = native.available
    native.available = lambda: False          # a host with no compiler
    try:
        t0 = time.perf_counter()
        lab_python = multilevel_partition(ell.adj, AMAZON_D,
                                          exact_block=block)
        t_python = time.perf_counter() - t0
    finally:
        native.available = available
    if not (calls.get("partition_refine") and calls.get("hem_match")):
        raise RuntimeError(f"multilevel_partition took no native call: "
                           f"{native.calls}")
    if not np.array_equal(lab_native, lab_python):
        raise RuntimeError("native and Python partitions differ")
    print(f"multilevel_partition, elliptic shape ({ell.n_nodes} nodes, "
          f"{ell.adj.nnz} entries), D {AMAZON_D}: native {t_native[1]:.3f} "
          f"s (first call {t_native[0]:.3f} s; calls over both {calls}), "
          f"Python route {t_python:.3f} s; labels equal")
    del ell

    t0 = time.perf_counter()
    ds = synthetic_like("Amazon")
    t_gen = time.perf_counter() - t0
    native.reset_calls()
    t0 = time.perf_counter()
    lp = reorder_lp(ds, AMAZON_D)
    t_lp = time.perf_counter() - t0
    calls = {k: n for k, n in native.calls.items() if n}
    blocks = np.arange(ds.n_nodes) // -(-ds.n_nodes // AMAZON_D)
    print(f"Amazon shape: {ds.n_nodes} nodes, {ds.adj.nnz} entries, "
          f"{ds.feat_dim} features, {len(labeled(ds))} labeled (generator "
          f"{t_gen:.3f} s); reorder_lp (multilevel, D {AMAZON_D}, native) "
          f"{t_lp:.3f} s, host library calls {calls}; cut fraction of the "
          f"{AMAZON_D} row blocks {cut_fraction(ds.adj, blocks):.4f} -> "
          f"{cut_fraction(lp.adj, blocks):.4f}")
    del ds

    kw = dict(embedding_dim=N_H, noise_mean=0.02, noise_std=0.01)
    native.reset_calls()
    t0 = time.perf_counter()
    ref = FullBatchTrainer(lp, device=cuda, **kw)
    ref.prepare_training()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    calls = {k: n for k, n in native.calls.items() if n}
    init = ref.init()
    gen = torch.Generator(cuda).manual_seed(9)
    noises = [ref.draw_noise(gen) for _ in range(AMAZON_STEPS)]
    r = halo_steps(ref, init, noises, timed=True)
    print(f"Amazon single-device reference ({ref.route}, tile height "
          f"{ref.adj.tiles.fwd.tile_height}): prepare {t_ref:.3f} s (host "
          f"library calls {calls}); step ms {[round(x, 3) for x in r[2]]}")
    single = (ref.adj.tiles, lp.feat_dim)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    tr = FullBatchTrainer(lp, mesh=AMAZON_D, dist_schedule=AMAZON_SCHEDULE,
                          device=cuda, **kw)
    torch.cuda.synchronize()
    prep = time.perf_counter() - t0
    calls = {k: n for k, n in native.calls.items() if n}
    held = (torch.cuda.memory_allocated() - base) / 1e6
    h = halo_steps(tr, init, noises, timed=True)
    n1, n2 = read_launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    counts = (AMAZON_D * (HALO_K1["prepare"] + AMAZON_STEPS * HALO_K1["step"]
                          + HALO_K1["eval"]),
              AMAZON_D * AMAZON_STEPS * HALO_K2_STEP)
    if tr.route != "bcsr" or (n1, n2) != counts:
        raise RuntimeError(f"halo Amazon: route {tr.route}, K1 {n1}, K2 "
                           f"{n2}; expected bcsr, {counts}")
    path = f"halo Amazon D{AMAZON_D} {AMAZON_SCHEDULE}"
    k1["float32"]["paths"][path] = n1
    k2["float32"]["paths"][path] = n2
    d = (assert_close_rel(h[0], r[0], LOSS_TOL, "Amazon halo losses"),
         assert_close_rel(h[1], r[1], SCORE_TOL, "Amazon halo scores"))
    print(f"{path} float32: prepare {prep:.3f} s (host library calls "
          f"{calls}), device memory held {held:.1f} MB, peak {peak:.1f} MB "
          f"above the start; K1 {n1}, K2 {n2} launches ({AMAZON_STEPS} "
          f"steps + an evaluation); step ms {[round(x, 3) for x in h[2]]} "
          f"(median {statistics.median(h[2]):.3f}; single-device "
          f"{statistics.median(r[2]):.3f}); vs single-device losses / "
          f"scores max|d| {d[0]:.3g} / {d[1]:.3g} (tol {LOSS_TOL}·(1 + "
          f"|ref|))")
    for line in halo_layout_lines(tr):
        print(line)
    later.append(partial(busy_line,
                         f"halo step D{AMAZON_D} Amazon {AMAZON_SCHEDULE}",
                         halo_step_fn(tr, noises[0]),
                         statistics.median(h[2]), AMAZON_STEPS))
    print(f"Amazon halo phase {time.perf_counter() - t_phase:.1f} s")
    return tr, single


def amazon_rect_checks(tr, k1: dict) -> None:
    """Every shard's Amazon rect sets at d 300 held against their plain
    versions (the local and remote forward sets and their transposes);
    shard 0's forward sets timed against the bound, the plain version and
    ``torch.sparse.mm``."""
    import torch

    setup = tr._sharded
    t, plan = setup.tiles, setup.plan
    R, W = plan.rows_per_shard, plan.buf_width
    gen = torch.Generator(tr.device).manual_seed(6)
    h, buf, g = (torch.randn(n, N_H, device=tr.device, generator=gen)
                 for n in (R, W, R))
    keep = K1_KEEP
    recs, errs = {}, []
    for name, per_shard, x, n_out in (
            ("local", t.loc, h, R), ("remote", t.fwd, buf, R),
            ("local transposed", t.locT, g, R),
            ("remote transposed", t.bwd, g, W)):
        for i, tiles in enumerate(per_shard):
            timed = i == 0 and "transposed" not in name
            rec = check_k1(tiles, x, "float32", n_out=n_out, timed=timed)
            errs.append(rec["max_abs_err"])
            if timed:
                recs[f"{name} d{N_H}"] = {k: rec[k] for k in keep}
                if name == "remote":
                    recs[f"{name} d{N_H}"]["pace"] = walk_pace(tiles, x,
                                                               n_out)
                print(f"K1 Amazon halo {name} float32 shard 0: "
                      f"T={tiles.n_tiles} tile height {tiles.tile_height} "
                      f"{tiles.n_rows}x{tiles.n_cols} d={N_H}: "
                      f"{json.dumps(recs[f'{name} d{N_H}'])}")
    k1["float32"]["amazon_halo_rect"] = recs
    k1["float32"]["max_abs_err"] = max(k1["float32"]["max_abs_err"], *errs)
    print(f"Amazon halo rect sets: {len(errs)} K1 checks on {len(t.loc)} "
          f"shards, max|d| {max(errs):.3g}")


def profile_dir_phase(cuda, k1: dict, k2: dict) -> None:
    """Phase 8e: ``train()`` with ``profile_dir`` on the photo shape; the
    Chrome trace's K1 kernel events (by the kernel's symbol) equal the
    launch counter read over the traced window, and K2 has none."""
    import torch

    from ggad_tpu_torch.datasets.synthetic import photo_bench
    from ggad_tpu_torch.train import full_batch
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    marks = {}

    class CountingWindow(full_batch.ProfileWindow):
        """The trainer's window, reading the launch counters when the
        trace starts and when it stops."""

        def before(self, epoch):
            idle = self.prof is None
            super().before(epoch)
            if idle and self.prof is not None:
                marks["start"] = read_launches()

        def after(self, epoch, last_value):
            tracing = self.prof is not None
            super().after(epoch, last_value)
            if tracing and self.prof is None:
                marks["stop"] = read_launches()

    gc.collect()
    torch.cuda.empty_cache()
    ds = photo_bench()
    window = full_batch.ProfileWindow
    full_batch.ProfileWindow = CountingWindow
    try:
        with tempfile.TemporaryDirectory() as out:
            tr = FullBatchTrainer(ds, embedding_dim=N_H,
                                  num_epoch=PROFILE_EPOCHS,
                                  eval_every=PROFILE_EVAL_EVERY,
                                  profile_dir=out, device=cuda)
            reset_launches()
            t0 = time.perf_counter()
            res = tr.train()
            wall = time.perf_counter() - t0
            n1, n2 = read_launches()
            files = os.listdir(out)
            with open(os.path.join(out, files[0])) as f:
                trace = json.load(f)["traceEvents"]
            size = os.path.getsize(os.path.join(out, files[0]))
    finally:
        full_batch.ProfileWindow = window
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    ev1 = sum(K1_SYMBOL in e["name"] for e in kernels)
    ev2 = sum(K2_SYMBOL in e["name"] for e in kernels)
    steps = sorted(int(e["name"].split()[1]) for e in trace
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train_step "))
    w1 = marks["stop"][0] - marks["start"][0]
    w2 = marks["stop"][1] - marks["start"][1]
    want = 3 * 2 + 1                # 3 steps of 2, epoch 3's evaluation
    if (files != ["trace_steps_2_4.json"] or steps != [2, 3, 4]
            or (ev1, w1) != (want, want) or (ev2, w2) != (0, 0)):
        raise RuntimeError(f"profile_dir: files {files}, traced steps "
                           f"{steps}, K1 events {ev1} / counter {w1}, K2 "
                           f"events {ev2} / counter {w2}; expected K1 "
                           f"{want}, K2 0")
    path = "profile_dir photo train()"
    k1["float32"]["paths"][path] = n1
    k2["float32"]["paths"][path] = n2
    device_us = sum(e.get("dur", 0) for e in kernels)
    print(f"profile_dir: photo f32 train() {PROFILE_EPOCHS} epochs "
          f"({wall:.3f} s, final AUROC {res.final_auc:.4f}), K1 {n1} "
          f"launches in all; trace {files[0]} ({size / 1e6:.1f} MB, "
          f"{len(trace)} events, steps {steps}): K1 kernel events {ev1} = "
          f"counter over the window {w1}, K2 {ev2} = {w2}; {len(kernels)} "
          f"kernels, {device_us / 1e3:.3f} ms of kernel time in the window")


def amazon_single_checks(pair, feat_dim: int, k1: dict) -> None:
    """The single-device Amazon trainer's K1 shapes held against their
    plain versions and timed: its forward tiles at the feature width (the
    hoisted Â·x) and at d 300, its transposed tiles at d 300 (the
    backward)."""
    import torch

    cuda = pair.fwd.values.device
    gen = torch.Generator(cuda).manual_seed(7)
    recs, errs = {}, []
    for name, tiles, d in (("forward", pair.fwd, feat_dim),
                           ("forward", pair.fwd, N_H),
                           ("transposed", pair.bwd, N_H)):
        h = torch.randn(pair.n_nodes, d, device=cuda, generator=gen)
        rec = check_k1(tiles, h, "float32", timed=True)
        errs.append(rec["max_abs_err"])
        key = f"{name} d{d}"
        recs[key] = {k: rec[k] for k in K1_KEEP}
        print(f"K1 Amazon single-device {name} float32: T={tiles.n_tiles} "
              f"tile height {tiles.tile_height} {tiles.n_rows}x"
              f"{tiles.n_cols} d={d}: {json.dumps(recs[key])}")
    k1["float32"]["amazon_single"] = recs
    k1["float32"]["max_abs_err"] = max(k1["float32"]["max_abs_err"], *errs)


def kernel_record(name, source, replaces, rec) -> dict:
    """One kernel's entry in the kernels line, from its photo record; K1's
    also carries its launches by route over the main paths (the walk or
    the staged route, fixed by each store's shape) and both routes' times
    on the photo shape."""
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
    for key in ("launches_by_route", "k1_route", "walk_ms", "staged_ms",
                "slab_mb", "smem_bytes", "blocks", "stages", "reuse",
                "staged_smem_mb", "staged_bound_ms",
                "at_d745", "tam_blockdiag", "halo_rect", "amazon_halo_rect",
                "amazon_single"):
        if key in rec:
            out[key] = rec[key]
    if "tile_rows_sweep" in rec:
        out["also_replaces"] = [STUDY_REPLACES]
        out["tile_rows_sweep"] = {
        r["tile_rows"]: {k: r[k] for k in ("spmm_ms", "k1_route", "walk_ms",
                                           "staged_ms", "slab_reuse")}
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
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    routes_at_start = dict(bcsr_spmm.routes)
    # the end-to-end phases first: they are timed with CUDA events and the
    # host clock, before any profiler session adds its launch overhead
    k1 = {"float32": {}, "bfloat16": {}}
    k2 = {"float32": {}, "bfloat16": {}}
    later = []
    serving_phase(cuda, k1, later)
    training_phase(cuda, k1, k2, later)
    sparse_phase(cuda, k1, k2, later)
    mb = minibatch_phase(cuda, k1, k2, later)
    minibatch_baselines_phase(cuda, k1, k2, later, *mb)
    dp_phase(cuda, k1, k2, later, *mb)
    del mb
    zoo_phase(cuda, k1, k2, later)
    tam_pair = tam_phase(cuda, k1, k2, later)
    halo = halo_phase(cuda, k1, k2, later)
    gspmd_phase(cuda, k1, k2, later)
    amazon, amazon_single = amazon_halo_phase(cuda, k1, k2, later)
    profile_dir_phase(cuda, k1, k2)
    routes = {k: n - routes_at_start[k] for k, n in bcsr_spmm.routes.items()}
    print(f"K1 launches by route over the main paths: {json.dumps(routes)}")
    for dtype in k1:
        k1[dtype]["launches_by_route"] = {
            r: routes[f"{r}_{SHORT[dtype]}"] for r in ("staged", "walk")}
    kernel_phase(cuda, k1, k2)
    tam_kernel_checks(tam_pair, k1)
    for dtype, tr in halo.items():
        halo_rect_checks(tr, dtype, k1, k2)
    amazon_rect_checks(amazon, k1)
    amazon_single_checks(*amazon_single, k1)
    del halo, amazon, amazon_single
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
