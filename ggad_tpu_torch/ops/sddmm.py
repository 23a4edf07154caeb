"""SDDMM and GGAD's local affinity (counterpart of ``ggad_tpu/ops/sddmm.py``).

The reference masks an N×N cosine-similarity matrix by the raw adjacency
(``run.py:182-188``); only edge entries survive, so the affinity is a
sampled dense-dense product (SDDMM) over raw_adj's edges followed by a
column sum, O(E·d). On a graph that carries BCSR tiles the numerator runs
in K2 (``ops.bcsr_sddmm``), on one that carries ELL tables through their
transposed table (``ops.ell_spmm``).

The margin loss reads the affinity only at the labeled nodes, so the
trainer restricts the SDDMM to their columns: :class:`AffinitySubset`
(edge-parallel), :class:`TileAffinitySubset` (rectangular tiles, K2) or
:class:`~ggad_tpu_torch.ops.ell_spmm.ELLAffinitySubset` (rectangular ELL
tables).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggad_tpu_torch.ops.bcsr_sddmm import (
    bcsr_sddmm_colsum,
    bcsr_sddmm_colsum_rect,
)
from ggad_tpu_torch.ops.bcsr_spmm import (
    BCSRGraph,
    BCSRPair,
    bcsr_rect_from_coo,
    pick_tile_rows,
)
from ggad_tpu_torch.ops.ell_spmm import (
    ELLAffinitySubset,
    ELLGraph,
    ell_affinity_colsum,
    ell_subset_colsum,
)
from ggad_tpu_torch.utils.tracing import span


def sddmm_dot(g, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product e ↦ val[e] · ⟨a[row[e]], b[col[e]]⟩; [E_pad]
    f32, 0 on padding edges (val == 0)."""
    return (a[g.row] * b[g.col]).sum(-1) * g.val


def l2_normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Row L2-normalize; zero rows stay zero (the reference's inf-guard,
    ``run.py:177-180``). The guard sits inside the sqrt: sqrt'(0) = inf
    would make a zero row's gradient NaN (``sddmm.py:35-46``)."""
    sq = x.square().sum(-1, keepdim=True)
    pos = sq > 0
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return x * torch.where(pos, 1.0 / norm, torch.zeros_like(norm))


def edge_cosine(g, emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity along each edge of ``g`` (val-weighted)."""
    emb_n = l2_normalize_rows(emb)
    return sddmm_dot(g, emb_n, emb_n)


def _inverse(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den != 0, 1.0 / den, torch.zeros_like(den))


def node_affinity(g, emb: torch.Tensor) -> torch.Tensor:
    """GGAD's per-node local affinity (reference ``run.py:177-188``):

        affinity[j] = Σ_{e: col[e]=j} cos(emb[row[e]], emb[j]) · val[e]
                      / Σ_{e: col[e]=j} val[e]

    with 1/0 → 0. ``g`` is the raw adjacency plus self-loops. A
    :class:`BCSRGraph` takes K2, an :class:`ELLGraph` its table pair, a
    plain graph the edge-parallel path; each under the ``affinity`` span.
    """
    with span("affinity"):
        inv = _inverse(g.in_degrees())
        if isinstance(g, BCSRGraph):
            num = bcsr_sddmm_colsum(g.tiles, l2_normalize_rows(emb))
        elif isinstance(g, ELLGraph):
            num = ell_affinity_colsum(g.tables, l2_normalize_rows(emb))
        else:
            num = torch.zeros(g.n_nodes, dtype=emb.dtype, device=emb.device)
            num = num.index_add(0, g.col, edge_cosine(g, emb))
        return num * inv


@dataclasses.dataclass(frozen=True)
class AffinitySubset:
    """The edges of a graph whose column is in a node subset, with the
    columns renumbered to subset positions (``sddmm.py:88-109``)."""

    row: torch.Tensor        # [E_sub_pad] global source ids
    col_local: torch.Tensor  # [E_sub_pad] position of the column in uniq
    val: torch.Tensor        # [E_sub_pad] edge values (0 on padding)
    uniq: torch.Tensor       # [U] unique subset node ids
    gather: torch.Tensor     # [S] position of idx[k] in uniq (idx repeats)
    den: torch.Tensor        # [U] column sums of val
    n_uniq: int


def _subset_edges(g, idx):
    """Host side: the unique ids of ``idx``, the position of each request
    among them, and ``g``'s edges into them with local column ids."""
    idx = np.asarray(idx, np.int64)
    uniq, gather = np.unique(idx, return_inverse=True)
    row, col, val = g.host_coo()
    lookup = np.full(g.n_nodes, -1, np.int64)
    lookup[uniq] = np.arange(len(uniq))
    sel = lookup[col] >= 0
    return uniq, gather, row[sel], lookup[col[sel]], val[sel]


def affinity_subset(g, idx) -> AffinitySubset:
    """Restrict ``g``'s edges to columns in ``idx`` (``sddmm.py:112-141``),
    padded to a multiple of 8 with zero-valued edges."""
    uniq, gather, r, c, v = _subset_edges(g, idx)
    order = np.argsort(c, kind="stable")
    r, c, v = r[order], c[order], v[order]
    e = len(r)
    e_pad = max(-(-e // 8) * 8, 8)
    rp = np.zeros(e_pad, np.int64)
    cp = np.full(e_pad, c[-1] if e else 0, np.int64)
    vp = np.zeros(e_pad, np.float32)
    rp[:e], cp[:e], vp[:e] = r, c, v
    den = np.zeros(len(uniq), np.float32)
    np.add.at(den, c, v)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(g.device)

    return AffinitySubset(row=dev(rp), col_local=dev(cp), val=dev(vp),
                          uniq=dev(uniq), gather=dev(gather.ravel()),
                          den=dev(den), n_uniq=len(uniq))


@dataclasses.dataclass(frozen=True)
class TileAffinitySubset:
    """Column-subset affinity on rectangular tiles of ``A[:, uniq]``
    (``[N × U]``, columns renumbered), driving
    :func:`~ggad_tpu_torch.ops.bcsr_sddmm.bcsr_sddmm_colsum_rect`."""

    pair: BCSRPair           # fwd [N × U], bwd [U × N]
    uniq: torch.Tensor       # [U] unique subset node ids
    gather: torch.Tensor     # [S] position of idx[k] in uniq
    inv_den: torch.Tensor    # [U] 1 / column sum (0 where isolated)
    n_uniq: int


def tile_affinity_subset(g, idx, *, dtype="float32",
                         tile_rows: int | None = None) -> TileAffinitySubset:
    """Rectangular-tile restriction of ``g`` to the columns in ``idx``
    (``sddmm.py:165-198``). One tile height, picked on the ``[N × U]``
    edges, serves both orientations."""
    uniq, gather, r, c, v = _subset_edges(g, idx)
    v = v.astype(np.float32)
    den = np.zeros(len(uniq), np.float32)
    np.add.at(den, c, v)
    if tile_rows is None:
        tile_rows = pick_tile_rows(r, c, g.n_nodes)
    fwd = bcsr_rect_from_coo(r, c, v, g.n_nodes, len(uniq), dtype=dtype,
                             tile_rows=tile_rows, device=g.device)
    bwd = bcsr_rect_from_coo(c, r, v, len(uniq), g.n_nodes, dtype=dtype,
                             tile_rows=tile_rows, device=g.device)
    inv = np.where(den != 0, 1.0 / den, 0.0).astype(np.float32)
    return TileAffinitySubset(
        pair=BCSRPair(fwd=fwd, bwd=bwd, n_nodes=g.n_nodes),
        uniq=torch.from_numpy(uniq).to(g.device),
        gather=torch.from_numpy(gather.ravel()).to(g.device),
        inv_den=torch.from_numpy(inv).to(g.device), n_uniq=len(uniq))


def node_affinity_at(sub, emb: torch.Tensor) -> torch.Tensor:
    """affinity[k] for the k-th requested node: the values of
    ``node_affinity(g, emb)[idx]`` (``sddmm.py:201-223``), edge-parallel,
    through K2 for a :class:`TileAffinitySubset` or through the rectangular
    tables of an :class:`ELLAffinitySubset`, under the ``affinity`` span."""
    with span("affinity"):
        emb_n = l2_normalize_rows(emb)
        if isinstance(sub, ELLAffinitySubset):
            num = ell_subset_colsum(sub, emb_n)
            return (num * sub.inv_den)[sub.gather]
        tgt = emb_n[sub.uniq]
        if isinstance(sub, TileAffinitySubset):
            num = bcsr_sddmm_colsum_rect(sub.pair, tgt, emb_n)
            return (num * sub.inv_den)[sub.gather]
        cos = (emb_n[sub.row] * tgt[sub.col_local]).sum(-1) * sub.val
        num = torch.zeros(sub.n_uniq, dtype=emb.dtype, device=emb.device)
        num = num.index_add(0, sub.col_local, cos)
        return (num * _inverse(sub.den))[sub.gather]
