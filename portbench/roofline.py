"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes of each product counted from shapes, and CUDA-event timing.

Peaks are NVIDIA's for one H100 SXM at its full 700 W: 67 TFLOP/s in
float32 outside the tensor cores (the port keeps TF32 off for f32
parity, so that is the peak its f32 products can reach) and 3.35 TB/s of
HBM. Operations count 2 per multiply-add of the dense products and 2·nnz·d
for each sparse product; elementwise work is not counted.
"""

from __future__ import annotations

import statistics

PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def dense(m: int, k: int, n: int) -> float:
    """Operations of an ``[m, k] @ [k, n]`` product."""
    return 2.0 * m * k * n


def sparse(nnz: int, d: int) -> float:
    """Operations of a sparse ``[n, n] @ [n, d]`` product with nnz entries
    (or of an SDDMM's dot products over nnz entries at width d)."""
    return 2.0 * nnz * d


def spmm_bytes(nnz: int, n_rows: int, n_in: int, d: int,
               item: int = 4) -> float:
    """Bytes an SpMM needs to move once: each stored entry's column (4
    bytes) and value, the row pointers, the dense operand and the f32
    output."""
    return nnz * (4 + item) + (n_rows + 1) * 4 + n_in * d * item \
        + n_rows * d * 4


def spmm_least_s(nnz: int, n_rows: int, n_in: int, d: int) -> float:
    """The least time of an f32 SpMM on the card: the larger of its
    operations at the f32 peak and its bytes at the HBM rate."""
    return max(sparse(nnz, d) / PEAK_F32_FLOPS,
               spmm_bytes(nnz, n_rows, n_in, d) / HBM_BYTES_PER_S)


def head_flops(rows: int, h: int) -> float:
    """GGAD's scoring head h → h/2 → h/4 → 1 on ``rows`` rows."""
    return dense(rows, h, h // 2) + dense(rows, h // 2, h // 4) \
        + dense(rows, h // 4, 1)


def ggad_score_flops(*, n: int, f: int, h: int, nnz: int) -> float:
    """One scoring request: gcn1 on the hoisted Â·x, gcn2, the head on
    every node."""
    return dense(n, f, h) + dense(n, h, h) + sparse(nnz, h) \
        + head_flops(n, h)


def ggad_train_flops(*, n: int, f: int, h: int, nnz: int, nnz_seed: int,
                     n_normal: int, n_seed: int, nnz_sub: int) -> float:
    """One training step, forward and backward. Forward: gcn1 on the
    hoisted Â·x, gcn2 (dense, then Â), the seed rows' aggregation (the
    seed rows of Â), fc4, the head on [normals ‖ generated], the margin's
    affinity (a dot per entry of the labeled columns). Backward: gcn1's
    weight gradient only (its input is constant), both gradients of every
    other dense product, Âᵀ for each sparse product, and the affinity's
    two products."""
    fwd = (dense(n, f, h) + dense(n, h, h) + sparse(nnz, h)
           + sparse(nnz_seed, h) + dense(n_seed, h, h)
           + head_flops(n_normal + n_seed, h) + sparse(nnz_sub, h))
    bwd = (dense(n, f, h) + 2 * dense(n, h, h) + sparse(nnz, h)
           + sparse(nnz_seed, h) + 2 * dense(n_seed, h, h)
           + 2 * head_flops(n_normal + n_seed, h) + 2 * sparse(nnz_sub, h))
    return fwd + bwd


def tam_epoch_flops(*, n: int, f: int, h: int, member_nnz, nnz_raw: int
                    ) -> float:
    """One TAM epoch over every member: gcn1 (f → 2h) and gcn2 (2h → h)
    on the member's normalised graph, the affinity on the raw graph (a dot
    per entry), and the backward (gcn1's weight gradient only, both
    gradients of gcn2's dense product, Âᵀ for each sparse product, the
    affinity's two products)."""
    total = 0.0
    for nnz in member_nnz:
        fwd = (dense(n, f, 2 * h) + sparse(nnz, 2 * h) + dense(n, 2 * h, h)
               + sparse(nnz, h) + sparse(nnz_raw, h))
        bwd = (dense(n, f, 2 * h) + sparse(nnz, 2 * h)
               + 2 * dense(n, 2 * h, h) + sparse(nnz, h)
               + 2 * sparse(nnz_raw, h))
        total += fwd + bwd
    return total


def event_ms(fn, iters: int = 10) -> float:
    """Median device milliseconds of one call: CUDA events around each of
    ``iters`` calls, all enqueued behind a sleep on the card so that the
    host's launch time stays out of the intervals."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)
