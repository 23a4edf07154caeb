"""ELL (padded neighbour-table) SpMM, the sparse regime (counterpart of
``ggad_tpu/ops/ell_spmm.py``).

On a graph whose occupied 128×128 tiles hold few edges (elliptic-shaped:
2.4 edges a tile), a tile store costs far more than the edges. This path
pads each row's neighbour list to K slots instead:

    idx/val tables [K, N], slot-major
    out[n] = Σ_k val[k, n] · x[idx[k, n]]

Two layouts share the slot rule (edges lexsorted by (row, col); an edge's
slot is its rank within its row):

  * :class:`ELL` ("flat"): one K for every row, picked by a cost model;
    the edges past K spill to a COO residual.
  * :class:`ELLSigma` ("sigma", the trainer's): rows grouped by degree into
    buckets of K = 2, 4, …, 64, so only rows past the cap of 64 (and rows
    of buckets too small to keep, merged downward) spill.

Each table is gathered once per bucket: the ``[K·N_b]`` ids index the
operand, the rows are viewed as ``[K, N_b, d]``, multiplied by the values
in the table's type and summed over K in f32. A gather larger than
``_OV_CHUNK_ELEMS`` elements runs in row chunks, as the residual does.

bf16 rounds where the JAX package rounds: the slot operands are cast to the
table's bf16 and each product is rounded to bf16 before the f32 sum; the
residual uses the f32 operand and f32 values; the column sums add exact
bf16 products in f32.

The products are differentiable in the dense operand
(``torch.autograd.Function``), their backward a product with the
transposed tables; the adjacency is not trained. Everything here is plain
PyTorch: the JAX path is XLA gathers and adds, with no Pallas kernel.

Each pass over a table runs under the spans ``ell.buckets`` and
``ell.residual`` (``utils.tracing``), and counts what it gathers:
``ell_spmm.bucket_slots`` (slots of bucket or flat tables),
``ell_spmm.residual_entries`` and ``ell_spmm.residual_chunks`` (the
residual's entries, padding included, and its chunks).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.ops.bcsr_spmm import storage_dtype
from ggad_tpu_torch.utils.tracing import span

# cap on the elements of one gathered block (256 MB in f32); larger
# gathers run in chunks (``ell_spmm.py:445``)
_OV_CHUNK_ELEMS = 1 << 26
# bucket K ladder; buckets under _SIGMA_MIN_ROWS rows merge downward, their
# tail edges spilling to the residual (``ell_spmm.py:213-214``)
_SIGMA_LADDER = (2, 4, 8, 16, 32, 64)
_SIGMA_MIN_ROWS = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _residual_pad(n_ov: int) -> int:
    """A residual of ``n_ov`` edges is padded to a multiple of 512."""
    return max(_round_up(n_ov, 512), 512) if n_ov else 0


def _dev(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Tables
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ELL:
    """Flat padded table plus COO residual for one orientation."""

    idx: torch.Tensor      # [K, N] int32 operand rows (0 on padding slots)
    val: torch.Tensor      # [K, N] values in the table's type (0 on padding)
    ov_row: torch.Tensor   # [E_ov_pad] int32 residual edges, sorted by row
    ov_col: torch.Tensor   # [E_ov_pad] int32
    ov_val: torch.Tensor   # [E_ov_pad] float32 (0 on padding)
    n_rows: int

    @property
    def k(self) -> int:
        return self.idx.shape[0]

    @property
    def n_overflow(self) -> int:
        return self.ov_row.shape[0]


def _pick_k(degrees: np.ndarray, coverage: float, k_max: int,
            spill_weight: float = 4.0) -> int:
    """The K minimising ``K·N + spill_weight·spill(K)`` over even K, the
    search stopping once a K covers ``coverage`` of the edges
    (``ell_spmm.py:71-101``; the weight was fitted on the TPU)."""
    if degrees.size == 0 or degrees.max() == 0:
        return 8
    n = degrees.size
    total = degrees.sum()
    best_k, best_cost = None, None
    for k in range(2, k_max + 1, 2):
        spill = int(np.maximum(degrees - k, 0).sum())
        cost = k * n + spill_weight * spill
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
        if np.minimum(degrees, k).sum() >= coverage * total:
            break
    return best_k


def _ell_layout(row, col, n_rows, k=None, coverage=0.98, k_max=64):
    """The slot rule shared by the flat tables and their value maps:
    ``(order, row_s, col_s, slot, in_ell, k, e_ov_pad)``, where ``order``
    maps a sorted position to the original edge (``ell_spmm.py:104-124``).
    """
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    order = np.lexsort((col, row))
    row_s, col_s = row[order], col[order]
    degrees = np.bincount(row_s, minlength=n_rows)
    if k is None:
        k = _pick_k(degrees, coverage, k_max)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    starts[1:] = np.cumsum(degrees)
    slot = np.arange(row_s.shape[0]) - starts[row_s]
    in_ell = slot < k
    return (order, row_s, col_s, slot, in_ell, k,
            _residual_pad(int((~in_ell).sum())))


def _residual(row_s, col_s, val_s, spill, device):
    """The spilled edges as a COO residual padded to a multiple of 512,
    padding rows repeating the last real row id (values 0), so the rows
    stay sorted."""
    n_ov = int(spill.sum())
    e_ov_pad = _residual_pad(n_ov)
    ov_row = np.zeros(e_ov_pad, np.int32)
    ov_col = np.zeros(e_ov_pad, np.int32)
    ov_val = np.zeros(e_ov_pad, np.float32)
    ov_row[:n_ov] = row_s[spill]
    ov_col[:n_ov] = col_s[spill]
    ov_val[:n_ov] = val_s[spill]
    if n_ov:
        ov_row[n_ov:] = ov_row[n_ov - 1]
    return _dev(ov_row, device), _dev(ov_col, device), _dev(ov_val, device)


def ell_from_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                 n_rows: int, *, k: int | None = None,
                 coverage: float = 0.98, k_max: int = 64,
                 dtype="float32", device: DeviceLike = None) -> ELL:
    """Host-side flat table from (unsorted) COO arrays
    (``ell_spmm.py:127-163``), moved to ``device`` once. ``dtype`` is the
    padded table's type; the residual stays f32."""
    device = resolve_device(device)
    val = np.asarray(val, dtype=np.float32)
    order, row_s, col_s, slot, in_ell, k, _ = _ell_layout(
        row, col, n_rows, k, coverage, k_max)
    val_s = val[order]
    idx = np.zeros((n_rows, k), dtype=np.int32)
    ell_val = np.zeros((n_rows, k), dtype=np.float32)
    idx[row_s[in_ell], slot[in_ell]] = col_s[in_ell]
    ell_val[row_s[in_ell], slot[in_ell]] = val_s[in_ell]
    ov_row, ov_col, ov_val = _residual(row_s, col_s, val_s, ~in_ell, device)
    return ELL(idx=_dev(idx.T, device),
               val=_dev(ell_val.T, device, storage_dtype(dtype)),
               ov_row=ov_row, ov_col=ov_col, ov_val=ov_val,
               n_rows=int(n_rows))


@dataclasses.dataclass(frozen=True)
class SigmaBucket:
    idx: torch.Tensor   # [K_b, N_b] int32 operand rows
    val: torch.Tensor   # [K_b, N_b] values (0 on padding)


@dataclasses.dataclass(frozen=True)
class ELLSigma:
    """Degree-bucketed table (``ell_spmm.py:170-205``): rows sorted by
    bucket (``perm``: new → old), each bucket's K covering its rows, the
    zero-degree rows a trailing zero block; ``inv`` (old → new) gathers
    the concatenated bucket outputs back into row order. Rows past the
    cap, and the rows of merged-down buckets, spill their tail edges to
    the COO residual."""

    buckets: tuple          # tuple[SigmaBucket, ...]
    perm: torch.Tensor      # [n_rows] int32
    inv: torch.Tensor       # [n_rows] int32
    ov_row: torch.Tensor    # [E_ov_pad] int32 residual, sorted by row
    ov_col: torch.Tensor
    ov_val: torch.Tensor    # float32
    n_rows: int
    n_zero: int

    @property
    def n_overflow(self) -> int:
        return self.ov_row.shape[0]

    @property
    def n_slots(self) -> int:
        return sum(b.idx.numel() for b in self.buckets)


def ell_sigma_from_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                       n_rows: int, *, dtype="float32",
                       device: DeviceLike = None) -> ELLSigma:
    """Host-side sigma tables from (unsorted) COO arrays
    (``ell_spmm.py:217-294``), moved to ``device`` once."""
    device = resolve_device(device)
    val = np.asarray(val, dtype=np.float32)
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    order = np.lexsort((col, row))
    row_s, col_s, val_s = row[order], col[order], val[order]
    degrees = np.bincount(row_s, minlength=n_rows)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    starts[1:] = np.cumsum(degrees)
    slot = np.arange(row_s.shape[0]) - starts[row_s]

    # a row's bucket K: the smallest ladder step >= min(degree, cap)
    kk = np.minimum(degrees, _SIGMA_LADDER[-1])
    k_of = np.zeros(n_rows, np.int64)
    for step in reversed(_SIGMA_LADDER):
        k_of[(kk > 0) & (kk <= step)] = step
    # small buckets merge into their ladder predecessor
    for i in range(len(_SIGMA_LADDER) - 1, 0, -1):
        m = k_of == _SIGMA_LADDER[i]
        if 0 < int(m.sum()) < _SIGMA_MIN_ROWS:
            k_of[m] = _SIGMA_LADDER[i - 1]

    perm = np.argsort(np.where(k_of == 0, np.iinfo(np.int64).max, k_of),
                      kind="stable")
    inv = np.empty(n_rows, np.int64)
    inv[perm] = np.arange(n_rows)

    tdtype = storage_dtype(dtype)
    buckets = []
    pos = 0
    for step in _SIGMA_LADDER:
        nb = int(np.sum(k_of == step))
        if nb == 0:
            continue
        idx_b = np.zeros((nb, step), np.int32)
        val_b = np.zeros((nb, step), np.float32)
        sel = (k_of[row_s] == step) & (slot < step)
        local = inv[row_s[sel]] - pos
        idx_b[local, slot[sel]] = col_s[sel]
        val_b[local, slot[sel]] = val_s[sel]
        buckets.append(SigmaBucket(idx=_dev(idx_b.T, device),
                                   val=_dev(val_b.T, device, tdtype)))
        pos += nb
    ov_row, ov_col, ov_val = _residual(
        row_s, col_s, val_s, slot >= np.maximum(k_of[row_s], 1), device)
    return ELLSigma(buckets=tuple(buckets),
                    perm=_dev(perm, device, torch.int32),
                    inv=_dev(inv, device, torch.int32),
                    ov_row=ov_row, ov_col=ov_col, ov_val=ov_val,
                    n_rows=int(n_rows), n_zero=int(np.sum(k_of == 0)))


@dataclasses.dataclass(frozen=True)
class ELLValueMap:
    """Edge-order → flat-table value remap for one orientation
    (``ell_spmm.py:360-380``): a structure shared by graphs whose values
    differ rebuilds only its value planes,

        ell_val = where(slot_mask, v[slot_map], 0)     # [K, N]
        ov_val  = where(ov_mask,  v[ov_map],  0)       # [E_ov_pad]

    with ``v`` the edge values in the graph's edge order."""

    slot_map: torch.Tensor   # [K, N] int32 edge index (0 where empty)
    slot_mask: torch.Tensor  # [K, N] bool
    ov_map: torch.Tensor     # [E_ov_pad] int32
    ov_mask: torch.Tensor    # [E_ov_pad] bool


def ell_value_maps(row, col, n_rows: int, k: int, transpose: bool = False,
                   device: DeviceLike = None) -> ELLValueMap:
    """Host-side edge → slot maps of :func:`ell_from_coo`'s layout at this
    ``k``; ``transpose=True`` maps into the transposed table."""
    device = resolve_device(device)
    if transpose:
        row, col = col, row
    order, row_s, col_s, slot, in_ell, k, e_ov_pad = _ell_layout(
        row, col, n_rows, k)
    slot_map = np.zeros((n_rows, k), np.int32)
    slot_mask = np.zeros((n_rows, k), bool)
    slot_map[row_s[in_ell], slot[in_ell]] = order[in_ell]
    slot_mask[row_s[in_ell], slot[in_ell]] = True
    n_ov = int((~in_ell).sum())
    ov_map = np.zeros(e_ov_pad, np.int32)
    ov_mask = np.zeros(e_ov_pad, bool)
    ov_map[:n_ov] = order[~in_ell]
    ov_mask[:n_ov] = True
    return ELLValueMap(slot_map=_dev(slot_map.T, device),
                       slot_mask=_dev(slot_mask.T, device),
                       ov_map=_dev(ov_map, device),
                       ov_mask=_dev(ov_mask, device))


def ell_remap_values(m: ELLValueMap, v: torch.Tensor):
    """Edge-order values → (flat value plane, residual values)."""
    zero = v.new_zeros(())
    return (torch.where(m.slot_mask, v[m.slot_map], zero),
            torch.where(m.ov_mask, v[m.ov_map], zero))


@dataclasses.dataclass(frozen=True)
class ELLPair:
    """Forward and transposed tables (flat :class:`ELL` or
    :class:`ELLSigma`). ``bwd`` is None for a forward-only pair, which
    takes no gradient."""

    fwd: object
    bwd: Optional[object]
    n_nodes: int


def _table(row, col, val, n_rows, layout, device, kw):
    if layout == "sigma":
        return ell_sigma_from_coo(row, col, val, n_rows, device=device, **kw)
    if layout == "flat":
        return ell_from_coo(row, col, val, n_rows, device=device, **kw)
    raise ValueError(f"ELL layout is 'flat' or 'sigma', not {layout!r}")


def ell_pair_from_graph(g, *, layout: str = "flat", transpose: bool = True,
                        **kw) -> ELLPair:
    """Both orientations of ``g`` on its device (only the forward one
    unless ``transpose``); ``kw`` goes to the table build
    (``ell_spmm.py:428-441``)."""
    row, col, val = g.host_coo()
    fwd = _table(row, col, val, g.n_nodes, layout, g.device, kw)
    bwd = (_table(col, row, val, g.n_nodes, layout, g.device, kw)
           if transpose else None)
    return ELLPair(fwd=fwd, bwd=bwd, n_nodes=g.n_nodes)


# --------------------------------------------------------------------------
# Products
# --------------------------------------------------------------------------

def _row_chunks(n_rows: int, elems_per_row: int):
    """Row ranges whose gathered block holds at most ``_OV_CHUNK_ELEMS``
    elements."""
    step = max(_OV_CHUNK_ELEMS // max(elems_per_row, 1), 1)
    return [(lo, min(lo + step, n_rows)) for lo in range(0, n_rows, step)]


def _cat(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _slot_matmul(idx: torch.Tensor, val: torch.Tensor,
                 xc: torch.Tensor) -> torch.Tensor:
    """``Σ_k val[k, m] · xc[idx[k, m]]`` → ``[M, d]`` f32 for a slot-major
    ``[K, M]`` table: one gather of K·M rows, each product in the table's
    type, the sum over K in f32."""
    k, m = idx.shape
    d = xc.shape[1]
    ell_spmm.bucket_slots += k * m
    parts = []
    for lo, hi in _row_chunks(m, k * d):
        rows = xc.index_select(0, idx[:, lo:hi].reshape(-1))
        prod = rows.view(k, hi - lo, d) * val[:, lo:hi, None]
        parts.append(prod.float().sum(0))
    return _cat(parts)


def _slot_colsum(idx: torch.Tensor, val: torch.Tensor, ec: torch.Tensor,
                 tc: torch.Tensor) -> torch.Tensor:
    """``Σ_k val[k, m] · ⟨ec[idx[k, m]], tc[m]⟩`` → ``[M]`` f32: the
    products of the table-type operands are exact in f32 and summed in
    f32."""
    k, m = idx.shape
    d = ec.shape[1]
    ell_spmm.bucket_slots += k * m
    parts = []
    for lo, hi in _row_chunks(m, k * d):
        rows = ec.index_select(0, idx[:, lo:hi].reshape(-1))
        dots = (rows.view(k, hi - lo, d).float()
                * tc[lo:hi].float()).sum(-1)
        parts.append((val[:, lo:hi].float() * dots).sum(0))
    return _cat(parts)


def _overflow_spmm(ov_row, ov_col, ov_val, x, n_rows):
    """The residual's product ``out[r] += v · x[c]`` in f32, the
    ``[E_ov, d]`` gather in chunks of at most ``_OV_CHUNK_ELEMS`` elements
    (``ell_spmm.py:448-480``)."""
    e, d = ov_row.shape[0], x.shape[1]
    out = torch.zeros(n_rows, d, dtype=torch.float32, device=x.device)
    chunk = e if e * d <= _OV_CHUNK_ELEMS else max(_OV_CHUNK_ELEMS // d, 1)
    ell_spmm.residual_entries += e
    ell_spmm.residual_chunks += -(-e // chunk)
    for lo in range(0, e, chunk):
        hi = min(lo + chunk, e)
        out.index_add_(0, ov_row[lo:hi],
                       x[ov_col[lo:hi]] * ov_val[lo:hi, None])
    return out


def _overflow_colsum(m, emb_n, tgt):
    """The residual's ``num[r] += v · ⟨emb_n[c], tgt[r]⟩`` in f32, chunked
    as :func:`_overflow_spmm` (XLA fuses these gathers; here they are
    materialised)."""
    e, d = m.ov_row.shape[0], emb_n.shape[1]
    num = torch.zeros(m.n_rows, dtype=torch.float32, device=emb_n.device)
    chunk = e if e * d <= _OV_CHUNK_ELEMS else max(_OV_CHUNK_ELEMS // d, 1)
    ell_spmm.residual_entries += e
    ell_spmm.residual_chunks += -(-e // chunk)
    for lo in range(0, e, chunk):
        r, c = m.ov_row[lo:lo + chunk], m.ov_col[lo:lo + chunk]
        cos = (emb_n[c] * tgt[r]).sum(-1) * m.ov_val[lo:lo + chunk]
        num.index_add_(0, r, cos)
    return num


def _table_dtype(m, x: torch.Tensor) -> torch.dtype:
    if isinstance(m, ELLSigma):
        return m.buckets[0].val.dtype if m.buckets else x.dtype
    return m.val.dtype


def _sigma_matmul(s: ELLSigma, x: torch.Tensor) -> torch.Tensor:
    """out = M @ x: each bucket's product, the zero block, one gather back
    into row order, plus the residual (``ell_spmm.py:297-316``)."""
    with span("ell.buckets"):
        xc = x.to(_table_dtype(s, x))
        parts = [_slot_matmul(b.idx, b.val, xc) for b in s.buckets]
        if s.n_zero:
            parts.append(torch.zeros(s.n_zero, x.shape[1],
                                     dtype=torch.float32, device=x.device))
        out = _cat(parts).index_select(0, s.inv)
    if s.n_overflow:
        with span("ell.residual"):
            res = _overflow_spmm(s.ov_row, s.ov_col, s.ov_val, x, s.n_rows)
        out = out + res
    return out


def _sigma_colsum(s: ELLSigma, emb_n: torch.Tensor,
                  tgt: torch.Tensor) -> torch.Tensor:
    """num[u] = Σ_i M_ui ⟨emb_n[i], tgt[u]⟩ over the table's rows u
    (``ell_spmm.py:319-351``); ``tgt`` has one row per table row."""
    with span("ell.buckets"):
        ec = emb_n.to(_table_dtype(s, emb_n))
        tc = tgt.index_select(0, s.perm).to(ec.dtype)
        parts = []
        pos = 0
        for b in s.buckets:
            nb = b.idx.shape[1]
            parts.append(_slot_colsum(b.idx, b.val, ec, tc[pos:pos + nb]))
            pos += nb
        if s.n_zero:
            parts.append(torch.zeros(s.n_zero, dtype=torch.float32,
                                     device=emb_n.device))
        num = _cat(parts).index_select(0, s.inv)
    if s.n_overflow:
        with span("ell.residual"):
            res = _overflow_colsum(s, emb_n, tgt)
        num = num + res
    return num


def _ell_matmul(m: ELL, x: torch.Tensor) -> torch.Tensor:
    """out = M @ x for a flat table plus its residual
    (``ell_spmm.py:486-521``)."""
    with span("ell.buckets"):
        out = _slot_matmul(m.idx, m.val, x.to(m.val.dtype))
    if m.n_overflow:
        with span("ell.residual"):
            res = _overflow_spmm(m.ov_row, m.ov_col, m.ov_val, x, m.n_rows)
        out = out + res
    return out


def _ell_colsum_raw(m_t: ELL, emb_n: torch.Tensor,
                    tgt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """num[u] = Σ_i A_iu ⟨emb_n[i], tgt[u]⟩ on the transposed flat table
    (``ell_spmm.py:541-579``); ``tgt`` defaults to ``emb_n``."""
    if tgt is None:
        tgt = emb_n
    with span("ell.buckets"):
        num = _slot_colsum(m_t.idx, m_t.val, emb_n.to(m_t.val.dtype),
                           tgt.to(m_t.val.dtype))
    if m_t.n_overflow:
        with span("ell.residual"):
            res = _overflow_colsum(m_t, emb_n, tgt)
        num = num + res
    return num


def _matmul_any(m, x: torch.Tensor) -> torch.Tensor:
    if isinstance(m, ELLSigma):
        return _sigma_matmul(m, x)
    return _ell_matmul(m, x)


def _colsum_any(m, emb_n: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    if isinstance(m, ELLSigma):
        return _sigma_colsum(m, emb_n, tgt)
    return _ell_colsum_raw(m, emb_n, tgt)


class _ELLSpMM(torch.autograd.Function):
    """A @ x forward, Aᵀ g backward (``ell_spmm.py:524-538``); the
    backward under its own ``spmm`` span."""

    @staticmethod
    def forward(ctx, x, pair):
        ctx.pair = pair
        return _matmul_any(pair.fwd, x)

    @staticmethod
    def backward(ctx, g):
        with span("spmm"):
            return _matmul_any(ctx.pair.bwd, g), None


def ell_spmm(pair: ELLPair, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x, ``[n_rows(fwd), d]`` f32; differentiable in x through
    the transposed table, which a forward-only pair lacks."""
    if pair.bwd is None and x.requires_grad and torch.is_grad_enabled():
        raise ValueError("this ELL pair was built without its transposed "
                         "table (transpose=False) and takes no gradient")
    return _ELLSpMM.apply(x, pair)


ell_spmm.bucket_slots = 0
ell_spmm.residual_entries = 0
ell_spmm.residual_chunks = 0


class _ELLAffinityColsum(torch.autograd.Function):
    """Column sums of A ∘ (N Nᵀ); dN = A (g ⊙ N) + g ⊙ (Aᵀ N)
    (``ell_spmm.py:588-609``)."""

    @staticmethod
    def forward(ctx, emb_n, pair):
        ctx.pair = pair
        ctx.save_for_backward(emb_n)
        with span("affinity"):
            return _colsum_any(pair.bwd, emb_n, emb_n)

    @staticmethod
    def backward(ctx, g):
        (emb_n,) = ctx.saved_tensors
        pair = ctx.pair
        with span("affinity"):
            term1 = _matmul_any(pair.fwd, g[:, None] * emb_n)
            term2 = g[:, None] * _matmul_any(pair.bwd, emb_n)
            return term1 + term2, None


def ell_affinity_colsum(pair: ELLPair, emb_n: torch.Tensor) -> torch.Tensor:
    """Column sums of A ∘ (N Nᵀ) for row-normalised embeddings N; ``[N]``
    f32, differentiable in ``emb_n``. Needs both tables."""
    return _ELLAffinityColsum.apply(emb_n, pair)


# --------------------------------------------------------------------------
# Column-subset affinity (the sparse regime's margin)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ELLAffinitySubset:
    """Rectangular sigma tables of ``A[:, uniq]`` (columns renumbered) for
    the margin's column-subset affinity (``ell_spmm.py:616-643``).

    ``fwd``: ``[N × U]``, its ids address a ``[U, d]`` operand; ``bwd``:
    ``[U × N]``, its ids address the ``[N, d]`` embedding."""

    fwd: ELLSigma
    bwd: ELLSigma
    uniq: torch.Tensor      # [U] int32 unique subset node ids
    gather: torch.Tensor    # [S] int32 position of idx[k] in uniq
    inv_den: torch.Tensor   # [U] f32 1 / column sum (0 where isolated)
    umask: torch.Tensor     # [N] bool: the node is in uniq
    upos: torch.Tensor      # [N] int32: its position in uniq (0 elsewhere)
    n_uniq: int


def ell_affinity_subset(g, idx, *, dtype="float32") -> ELLAffinitySubset:
    """Host-side: ``g`` restricted to the columns in ``idx`` (renumbered),
    both rectangular orientations on ``g``'s device
    (``ell_spmm.py:646-674``)."""
    idx = np.asarray(idx, np.int64)
    uniq, gather = np.unique(idx, return_inverse=True)
    row, col, val = g.host_coo()
    lookup = np.full(g.n_nodes, -1, np.int64)
    lookup[uniq] = np.arange(len(uniq))
    sel = lookup[col] >= 0
    r, c, v = row[sel], lookup[col[sel]], val[sel].astype(np.float32)
    den = np.zeros(len(uniq), np.float32)
    np.add.at(den, c, v)
    umask = np.zeros(g.n_nodes, bool)
    umask[uniq] = True
    upos = np.zeros(g.n_nodes, np.int32)
    upos[uniq] = np.arange(len(uniq))
    inv_den = np.where(den != 0, 1.0 / np.maximum(den, 1e-30), 0.0)
    dev = g.device
    return ELLAffinitySubset(
        fwd=ell_sigma_from_coo(r, c, v, g.n_nodes, dtype=dtype, device=dev),
        bwd=ell_sigma_from_coo(c, r, v, len(uniq), dtype=dtype, device=dev),
        uniq=_dev(uniq, dev, torch.int32),
        gather=_dev(gather.ravel(), dev, torch.int32),
        inv_den=_dev(inv_den, dev, torch.float32),
        umask=_dev(umask, dev), upos=_dev(upos, dev), n_uniq=len(uniq))


class _ELLSubsetColsum(torch.autograd.Function):
    """Column sums of R ∘ (N tgtᵀ), R = A[:, uniq], tgt = N[uniq];
    dN = R (g ⊙ tgt) + (g ⊙ Rᵀ N) at the uniq rows, the latter a masked
    gather rather than a scatter (``ell_spmm.py:677-705``)."""

    @staticmethod
    def forward(ctx, emb_n, sub):
        ctx.sub = sub
        ctx.save_for_backward(emb_n)
        with span("affinity"):
            return _colsum_any(sub.bwd, emb_n,
                               emb_n.index_select(0, sub.uniq))

    @staticmethod
    def backward(ctx, g):
        (emb_n,) = ctx.saved_tensors
        sub = ctx.sub
        with span("affinity"):
            z = g[:, None] * emb_n.index_select(0, sub.uniq)     # [U, d]
            term1 = _matmul_any(sub.fwd, z)                      # [N, d]
            w = g[:, None] * _matmul_any(sub.bwd, emb_n)         # [U, d]
            w_full = w.index_select(0, sub.upos)
            return term1 + torch.where(sub.umask[:, None], w_full,
                                       w_full.new_zeros(())), None


def ell_subset_colsum(sub: ELLAffinitySubset,
                      emb_n: torch.Tensor) -> torch.Tensor:
    """Column sums of ``A[:, uniq] ∘ (N N[uniq]ᵀ)``; ``[U]`` f32,
    differentiable in ``emb_n``."""
    return _ELLSubsetColsum.apply(emb_n, sub)


# --------------------------------------------------------------------------
# Graph-level wrapper (ops.spmm / ops.sddmm dispatch on it)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ELLGraph:
    """A Graph plus its ELL table pair; drop-in for ``ops.spmm``."""

    graph: object            # ggad_tpu_torch.graph.Graph
    tables: ELLPair
    layout: str = "flat"
    build_kw: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def row(self):
        return self.graph.row

    @property
    def col(self):
        return self.graph.col

    @property
    def val(self):
        return self.graph.val

    @property
    def indptr(self):
        return self.graph.indptr

    @property
    def n_nodes(self):
        return self.graph.n_nodes

    @property
    def n_edges(self):
        return self.graph.n_edges

    @property
    def device(self):
        return self.graph.device

    def out_degrees(self):
        return self.graph.out_degrees()

    def in_degrees(self):
        return self.graph.in_degrees()

    def with_transpose(self) -> "ELLGraph":
        """This graph with the transposed table (built now, in the forward
        table's layout and build options, unless it is there)."""
        if self.tables.bwd is not None:
            return self
        row, col, val = self.graph.host_coo()
        bwd = _table(col, row, val, self.n_nodes, self.layout, self.device,
                     self.build_kw)
        return dataclasses.replace(
            self, tables=dataclasses.replace(self.tables, bwd=bwd))


def as_ell_graph(g, *, layout: str = "flat", transpose: bool = True,
                 **kw) -> ELLGraph:
    """``g`` with its ELL tables on its device (``ell_spmm.py:751-755``):
    ``layout='sigma'`` (the trainer's) buckets rows by degree; the default
    flat layout keeps one K per table. Only the forward table unless
    ``transpose``; ``kw`` goes to the table build (``dtype``, and for the
    flat layout ``k``, ``coverage``, ``k_max``)."""
    return ELLGraph(graph=g, tables=ell_pair_from_graph(
        g, layout=layout, transpose=transpose, **kw), layout=layout,
        build_kw=dict(kw))
