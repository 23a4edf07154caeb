"""Block-sparse SDDMM row sums (counterpart of
``ggad_tpu/ops/pallas_sddmm.py``).

For a tile set M (``ops.bcsr_spmm.BCSR``) and two operand sets E_r, E_c:

    out[r] = Σ_c M[r, c] · ⟨E_r[r], E_c[c]⟩

On the transposed tiles of an adjacency A this is A's column sums of
A ∘ (N Nᵀ), the numerator of GGAD's affinity. It runs in the hand-written
CUDA kernel ``csrc/bcsr_sddmm.cu`` (K2's port), which walks the tile set's
non-zeros in compressed rows (``BCSR.row_ptr``, ``col``, ``val``), for
CUDA tensors and in :func:`bcsr_sddmm_colsum_plain`, a loop over tiles,
for CPU tensors.

The two differentiable entry points keep the JAX package's custom VJPs;
each backward is two launches of K1 (``ops.bcsr_spmm.bcsr_matmul``):

  * :func:`bcsr_sddmm_colsum` (square): dN = A (g ⊙ N) + g ⊙ (Aᵀ N);
  * :func:`bcsr_sddmm_colsum_rect`: d_buf = g ⊙ (Mᵀ emb_local),
    d_emb_local = M (g ⊙ buf).
"""

from __future__ import annotations

import torch

from ggad_tpu_torch.ops import _build
from ggad_tpu_torch.utils.tracing import span
from ggad_tpu_torch.ops.bcsr_spmm import (
    TILE,
    BCSR,
    BCSRPair,
    bcsr_matmul,
    check_operand,
    check_tiles,
    vector_rows,
)


def bcsr_sddmm_colsum_cuda(tiles: BCSR, e_row: torch.Tensor,
                           e_col: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. Every output
    element is written, so the output is ``torch.empty``."""
    v = tiles.values
    # as pallas_sddmm.py:79-83: the operands are rounded to bf16 once
    er, ec = vector_rows(e_row, v.dtype), vector_rows(e_col, v.dtype)
    out = torch.empty(n_out, dtype=torch.float32, device=e_row.device)
    _build.launch(
        "bcsr_sddmm",
        "bcsr_sddmm_f32" if v.dtype == torch.float32 else "bcsr_sddmm_bf16",
        e_row.device,
        [tiles.row_ptr.data_ptr(), tiles.col.data_ptr(),
         tiles.val.data_ptr(), er.data_ptr(), ec.data_ptr(), out.data_ptr()],
        [n_out, e_row.shape[1], er.shape[1], e_row.shape[0],
         e_col.shape[0]])
    bcsr_sddmm_colsum.launches += 1
    return out


def bcsr_sddmm_colsum_plain(tiles: BCSR, e_row: torch.Tensor,
                            e_col: torch.Tensor,
                            n_out: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over tiles,
    ``out[r-block] += rowsum(M_t ∘ (E_r[r-block] E_c[c-block]ᵀ))``, with
    both operands rounded to bf16 first when the tiles are bf16. Returns
    the first ``n_out`` rows (default: as many as ``e_row`` has)."""
    tr = tiles.tile_height
    d = e_row.shape[1]

    def padded(x, rows):
        xp = torch.zeros(rows, d, dtype=torch.float32, device=x.device)
        xp[:x.shape[0]] = x
        if tiles.values.dtype == torch.bfloat16:
            xp = xp.to(torch.bfloat16).float()
        return xp

    er = padded(e_row, tiles.n_rows)
    ec = padded(e_col, tiles.n_cols)
    out = torch.zeros(tiles.n_rows, dtype=torch.float32, device=e_row.device)
    for t, (r, c) in enumerate(zip(tiles.tile_rows.tolist(),
                                   tiles.tile_cols.tolist())):
        dots = er[r * tr:(r + 1) * tr] @ ec[c * TILE:(c + 1) * TILE].T
        out[r * tr:(r + 1) * tr] += (tiles.values[t].float() * dots).sum(1)
    return out[:e_row.shape[0] if n_out is None else n_out]


def sddmm_colsum(tiles: BCSR, e_row: torch.Tensor, e_col: torch.Tensor,
                 n_out: int | None = None) -> torch.Tensor:
    """The first ``n_out`` row sums of M ∘ (E_r E_cᵀ) for one tile set;
    not differentiable. ``e_row`` is ``[≤ n_rows, d]`` and ``e_col``
    ``[≤ n_cols, d]``, both f32 (rows past their count read as zero); out
    is ``[n_out]`` f32.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version. ``bcsr_sddmm_colsum.launches`` counts kernel launches.
    """
    n_out = e_row.shape[0] if n_out is None else n_out
    check_tiles(tiles)
    check_operand(tiles, e_row, tiles.n_rows, "e_row")
    check_operand(tiles, e_col, tiles.n_cols, "e_col")
    if e_row.shape[1] != e_col.shape[1]:
        raise ValueError(f"e_row has d={e_row.shape[1]}, e_col "
                         f"d={e_col.shape[1]}")
    if not 0 < n_out <= tiles.n_rows:
        raise ValueError(f"n_out={n_out}; the tiles have {tiles.n_rows} "
                         f"rows")
    if e_row.device.type == "cpu":
        return bcsr_sddmm_colsum_plain(tiles, e_row, e_col, n_out)
    if e_row.device.type != "cuda":
        raise ValueError(f"bcsr_sddmm runs on cuda or cpu, not "
                         f"{e_row.device}")
    return bcsr_sddmm_colsum_cuda(tiles, e_row, e_col, n_out)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous()


class _ColsumSquare(torch.autograd.Function):
    """``pallas_sddmm.py:115-147``: K2 on ``pair.bwd`` forward, two K1
    launches backward."""

    @staticmethod
    def forward(ctx, emb_n, pair):
        emb_n = _f32(emb_n)
        ctx.pair = pair
        ctx.save_for_backward(emb_n)
        # column sums of A == row sums of Aᵀ → the transposed tile set
        with span("affinity"):
            return sddmm_colsum(pair.bwd, emb_n, emb_n)

    @staticmethod
    def backward(ctx, g):
        (emb_n,) = ctx.saved_tensors
        pair = ctx.pair
        with span("affinity"):
            g = _f32(g)[:, None]
            term1 = bcsr_matmul(pair.fwd, (g * emb_n).contiguous())
            term2 = g * bcsr_matmul(pair.bwd, emb_n)
            return term1 + term2, None


class _ColsumRect(torch.autograd.Function):
    """``pallas_sddmm.py:154-196``: K2 on ``pair.bwd`` forward, two K1
    launches on the rectangular sets backward."""

    @staticmethod
    def forward(ctx, buf, emb_local, pair):
        buf, emb_local = _f32(buf), _f32(emb_local)
        ctx.pair = pair
        ctx.save_for_backward(buf, emb_local)
        with span("affinity"):
            return sddmm_colsum(pair.bwd, buf, emb_local)

    @staticmethod
    def backward(ctx, g):
        buf, emb_local = ctx.saved_tensors
        pair = ctx.pair
        with span("affinity"):
            g = _f32(g)[:, None]
            d_buf = g * bcsr_matmul(pair.bwd, emb_local, buf.shape[0])
            d_emb = bcsr_matmul(pair.fwd, (g * buf).contiguous(),
                                emb_local.shape[0])
            return d_buf, d_emb, None


def bcsr_sddmm_colsum(pair: BCSRPair, emb_n: torch.Tensor) -> torch.Tensor:
    """num_j = Σ_i A_ij ⟨n_i, n_j⟩ over the tile pair of a square
    adjacency; ``emb_n`` is ``[n, d]``, the result ``[n]`` f32.
    Differentiable in ``emb_n``; the matrix is constant.
    ``bcsr_sddmm_colsum.launches`` counts K2 launches from every caller."""
    return _ColsumSquare.apply(emb_n, pair)


def bcsr_sddmm_colsum_rect(pair: BCSRPair, buf: torch.Tensor,
                           emb_local: torch.Tensor) -> torch.Tensor:
    """partial_c = Σ_r M[r, c] ⟨emb_local_r, buf_c⟩ for a rectangular pair
    (fwd ``[R × C]``, bwd its transpose); ``buf`` is ``[C, d]``,
    ``emb_local`` ``[R, d]``, the result ``[C]`` f32. Differentiable in
    both operands."""
    return _ColsumRect.apply(buf, emb_local, pair)


bcsr_sddmm_colsum.launches = 0
