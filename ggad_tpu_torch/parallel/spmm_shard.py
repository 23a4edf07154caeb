"""Edge-partitioned SpMM and affinity over D shards (counterpart of
``ggad_tpu/parallel/spmm_shard.py``).

CSR row blocks go to shards; node-indexed arrays shard their node axis the
same way. A sharded array here is ``[n, R, ...]``: its leading axis holds
the ``n`` shards the mesh owns (``parallel.mesh``), R rows each.

**Boundary halo exchange** (the production path, ``spmm_shard.py:163-530``):
each shard knows, per peer, which of its rows the peer's edges read (the
boundary set), and one exchange moves only those rows. Three wire
schedules share one buffer layout (:class:`HaloPlan`): ``dense`` (one
all-to-all, every pair padded to the widest boundary B), ``ring`` (D−1
permutation rounds by distance, each padded to its own widest pair) and
``sched`` (rounds by max-weight matching). The affinity runs the exchange
forward (normalized rows) and back (per-column partial sums).

The per-shard aggregation has four forms, as in JAX:

  * :func:`spmm_halo`: edge-parallel gathers and ``index_add``
    (``edge_chunks`` bounds the gathered block);
  * :func:`spmm_halo_bcsr`: K1 (``ops.bcsr_spmm.bcsr_spmm_rect``) on the
    shard's local ``[R × R]`` pair over its own rows and on its remote
    ``[R × W]`` pair over the received buffer, forward and (on the
    transposed sets) backward;
  * :func:`spmm_halo_ell`: the flat ELL tables over ``[recv ‖ local]``;
  * :func:`spmm_halo_seed_rows`: only the seed rows, as column partials
    and one ``psum``.

The affinity: :func:`affinity_halo` (edge-parallel),
:func:`affinity_halo_bcsr` (K2, ``ops.bcsr_sddmm.bcsr_sddmm_colsum_rect``,
on the local and remote pairs) and :func:`affinity_halo_subset` (only the
labeled columns: two ``psum``s, K2 on the subset's rect tiles when it has
them). :func:`spmm_sharded` and :func:`affinity_sharded` all-gather
everything: the oracle.

The host-side build functions are numpy, element for element JAX's. They
return every shard's structure on the host; the ``place_*`` functions
keep the shards a mesh owns and move them to its device. Tile sets and ELL tables are kept
per shard, each at its own size: JAX pads them to the largest shard's
count to stack them on a device axis, and each shard here launches its
kernel on its own set.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum_rect
from ggad_tpu_torch.ops.bcsr_spmm import (
    TILE,
    BCSRPair,
    bcsr_rect_from_coo,
    bcsr_spmm_rect,
    pick_tile_rows,
    storage_dtype,
)
from ggad_tpu_torch.ops.ell_spmm import ELL, ELLPair, ell_from_coo, ell_spmm
from ggad_tpu_torch.ops.sddmm import l2_normalize_rows

HOST = torch.device("cpu")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inverse(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den != 0, 1.0 / den, torch.zeros_like(den))


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

def _to(obj, device: torch.device):
    """A tensor or a tile set / table dataclass on ``device`` (a BCSR
    derives its compressed rows there anew)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if f.init and isinstance(getattr(obj, f.name), torch.Tensor)})


def _place(obj, mesh, replicated: tuple = ()):
    """``obj`` with the shards ``mesh`` owns on its device: every tensor
    field but the ``replicated`` ones has a leading shard axis, every
    tuple of tile sets or tables one entry a shard."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = (v.to(mesh.device) if f.name in replicated
                          else v[mesh.shards].to(mesh.device))
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            kw[f.name] = tuple(_to(v[s], mesh.device) for s in mesh.shards)
    return dataclasses.replace(obj, **kw)


def _my(mesh) -> torch.Tensor:
    """The global ids of the owned shards, ``[n]``."""
    return torch.tensor(mesh.shards, dtype=torch.int64, device=mesh.device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 through ``index_select``, whose backward is
    an ``index_add``: advanced indexing's backward sorts the indices
    first, slow on the many repeats of padded send slots and clamped
    targets."""
    return x.index_select(0, idx.reshape(-1)).view(
        tuple(idx.shape) + tuple(x.shape[1:]))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard row gather: ``x [n, M, ...]``, ``idx [n, K]`` →
    ``[n, K, ...]``."""
    n, m = x.shape[:2]
    flat = idx + torch.arange(n, device=x.device)[:, None] * m
    return _take(x.reshape((n * m,) + tuple(x.shape[2:])), flat)


def _segment_sum(v: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Per-shard ``segment_sum``: ``v [n, E, ...]`` summed into ``num``
    segments by ``seg [n, E]`` → ``[n, num, ...]``."""
    n, e = seg.shape
    tail = tuple(v.shape[2:])
    flat = (seg + torch.arange(n, device=seg.device)[:, None] * num)
    out = v.new_zeros((n * num,) + tail)
    return out.index_add(0, flat.reshape(-1),
                         v.reshape((n * e,) + tail)).view((n, num) + tail)


# --------------------------------------------------------------------------
# Edge partition
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Row-partitioned edge blocks, equal padded size a shard
    (``spmm_shard.py:50-77``). ``row_local``, ``col`` and ``val`` are
    ``[D, E_shard]`` (``[n, E_shard]`` once placed): shard d's edges, its
    rows counted within its block. Padding edges have val 0 and
    row_local 0."""

    row_local: torch.Tensor   # int64
    col: torch.Tensor         # int64, global column
    val: torch.Tensor         # float32
    n_shards: int
    rows_per_shard: int
    e_shard: int
    n_nodes: int              # unpadded
    # the edge-parallel aggregation walks the edges in this many chunks,
    # bounding the gathered [e_shard / chunks, d] block (1 = one shot)
    edge_chunks: int = 1

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows_per_shard


def partition_edges(g, n_shards: int, *, edge_chunks: Optional[int] = None,
                    chunk_budget_bytes: int = 2 << 30,
                    feat_dim_hint: int = 300) -> EdgePartition:
    """Host-side: split ``g``'s edges (a ``graph.Graph``) into per-shard
    row blocks (``spmm_shard.py:80-124``). ``edge_chunks=None`` picks the
    fewest chunks keeping a chunk's ``[chunk, feat_dim_hint]`` f32 gather
    under ``chunk_budget_bytes``."""
    row, col, val = g.host_coo()
    rows_per = _round_up(g.n_nodes, n_shards) // n_shards
    owner = row // rows_per
    e_shard = 0
    blocks = []
    for d in range(n_shards):
        sel = owner == d
        blocks.append((row[sel] - d * rows_per, col[sel], val[sel]))
        e_shard = max(e_shard, int(sel.sum()))
    if edge_chunks is None:
        per_edge = feat_dim_hint * 4
        edge_chunks = max(1, -(-e_shard * per_edge // chunk_budget_bytes))
    e_shard = max(_round_up(e_shard, 8 * edge_chunks), 8 * edge_chunks)

    rl = np.zeros((n_shards, e_shard), np.int64)
    cc = np.zeros((n_shards, e_shard), np.int64)
    vv = np.zeros((n_shards, e_shard), np.float32)
    for d, (r, c, v) in enumerate(blocks):
        rl[d, : len(r)] = r
        cc[d, : len(c)] = c
        vv[d, : len(v)] = v
    return EdgePartition(row_local=_t(rl), col=_t(cc), val=_t(vv),
                         n_shards=n_shards, rows_per_shard=rows_per,
                         e_shard=e_shard, n_nodes=g.n_nodes,
                         edge_chunks=edge_chunks)


def place_partition(part: EdgePartition, mesh) -> EdgePartition:
    return _place(part, mesh)


def pad_nodes(x, part: EdgePartition) -> torch.Tensor:
    """A ``[N, ...]`` node array padded to the partition's ``D·R`` rows
    and split by shard: ``[D, R, ...]``, on ``x``'s device."""
    x = torch.as_tensor(x)
    pad = x.new_zeros((part.n_pad - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad]).view(
        (part.n_shards, part.rows_per_shard) + tuple(x.shape[1:]))


def place_nodes(x: torch.Tensor, mesh) -> torch.Tensor:
    """The owned shards of a ``[D, R, ...]`` node array, on the mesh's
    device."""
    return x[mesh.shards].to(mesh.device)


@dataclasses.dataclass(frozen=True)
class NodeIndex:
    """Global node ids (replicated) over a sharded node array: where each
    id the mesh owns sits (owned-shard position, row) and its position
    in ``idx``. Built once, so gathers and writes at a fixed index set
    (GGAD's seeds and labeled normals) need no host round trip."""

    idx: torch.Tensor     # [S] global ids
    shard: torch.Tensor   # [M] owned-shard position of each owned id
    row: torch.Tensor     # [M] its row in that shard
    pos: torch.Tensor     # [M] its position in idx


def node_index(idx, rows_per_shard: int, mesh) -> NodeIndex:
    """The :class:`NodeIndex` of global ids ``idx`` on ``mesh``'s shards
    of ``rows_per_shard`` rows, on its device."""
    idx = np.asarray(idx, np.int64)
    owner = idx // rows_per_shard
    shards = np.asarray(mesh.shards, np.int64)
    pos = np.flatnonzero(np.isin(owner, shards))
    dev = mesh.device
    return NodeIndex(
        idx=_t(idx).to(dev),
        shard=_t(np.searchsorted(shards, owner[pos])).to(dev),
        row=_t(idx[pos] - owner[pos] * rows_per_shard).to(dev),
        pos=_t(pos.astype(np.int64)).to(dev))


def gather_rows(mesh, x: torch.Tensor, ni: NodeIndex) -> torch.Tensor:
    """``x_global[ni.idx]`` of a sharded ``x [n, R, ...]``: each shard
    places the rows it owns and one ``psum`` replicates them,
    ``[S, ...]``."""
    parts = x.new_zeros((x.shape[0], ni.idx.shape[0]) + tuple(x.shape[2:]))
    rows = _take(x.reshape((-1,) + tuple(x.shape[2:])),
                 ni.shard * x.shape[1] + ni.row)
    parts = parts.index_put((ni.shard, ni.pos), rows)
    return mesh.psum(parts)


def set_rows(mesh, x: torch.Tensor, ni: NodeIndex,
             values: torch.Tensor) -> torch.Tensor:
    """``x_global.at[ni.idx].set(values)`` for a sharded ``x`` and
    replicated ``values [S, ...]`` (ids unique)."""
    v = mesh.pvary(values)
    return x.index_put((ni.shard, ni.row), _take(v, ni.pos))


# --------------------------------------------------------------------------
# All-gather oracle
# --------------------------------------------------------------------------

def spmm_sharded(part: EdgePartition, h: torch.Tensor,
                 mesh) -> torch.Tensor:
    """out = A @ h with the whole h gathered on every shard
    (``spmm_shard.py:144-160``): ``[n, R, d]`` → ``[n, R, d]``."""
    h_full = mesh.pvary(mesh.all_gather(h))
    gathered = _take(h_full, part.col) * part.val[..., None]
    return _segment_sum(gathered, part.row_local, part.rows_per_shard)


def affinity_sharded(part: EdgePartition, emb: torch.Tensor,
                     mesh) -> torch.Tensor:
    """Per-node local affinity with the whole embedding gathered
    (``spmm_shard.py:1282-1309``); replicated ``[D·R]``."""
    emb_n = l2_normalize_rows(mesh.pvary(mesh.all_gather(emb)))
    row_global = part.row_local + _my(mesh)[:, None] * part.rows_per_shard
    cos = ((_take(emb_n, row_global) * _take(emb_n, part.col)).sum(-1)
           * part.val)
    num = mesh.psum(_segment_sum(cos, part.col, part.n_pad))
    den = mesh.psum(_segment_sum(part.val, part.col, part.n_pad))
    return num * _inverse(den)


# --------------------------------------------------------------------------
# Boundary halo exchange
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The boundary exchange of one (graph, D) pair
    (``spmm_shard.py:167-234``).

    ``send_idx [D, W]``: the local rows each shard packs into its send
    buffer. ``dense`` (``dist_widths == ()``): one all-to-all, source s's
    chunk for shard d at ``d·B``, every chunk B rows. ``ring``/``sched``
    (``dist_widths = (B_1, …)``): round r ships shard s's chunk to
    ``round_perm(r)[s]``, padded to that round's widest pair, chunk r at
    ``Σ_{j<r} B_j`` in both buffers; zero-width rounds are skipped.

    ``col_remap [D, E]``: each edge's column as a row of the shard's
    combined buffer ``[recv (W rows) ‖ own rows (R)]`` (padding edges at
    W). ``den [D, R]``: each node's column sum of edge values (the
    affinity's denominator). ``boundary`` = B, the widest ordered pair.
    """

    send_idx: torch.Tensor    # int64
    col_remap: torch.Tensor   # int64
    den: torch.Tensor         # float32
    n_shards: int
    boundary: int
    rows_per_shard: int
    dist_widths: tuple = ()
    # per-round destinations (round r: source s → dist_perms[r][s]); empty
    # with dist_widths set means the ring's (s + r + 1) mod D
    dist_perms: tuple = ()

    @property
    def buf_width(self) -> int:
        """Rows of the packed send and receive buffers."""
        if self.dist_widths:
            return int(sum(self.dist_widths))
        return self.n_shards * self.boundary

    def round_perm(self, r: int) -> list:
        """Destination of each source shard in exchange round r."""
        D = self.n_shards
        if self.dist_perms:
            return list(self.dist_perms[r])
        return [(s + r + 1) % D for s in range(D)]


def _halo_exchange(plan: HaloPlan, send: torch.Tensor, mesh,
                   reverse: bool = False) -> torch.Tensor:
    """Wire a packed ``[n, W, ...]`` send buffer to its peers and return
    the packed receive buffer (``spmm_shard.py:237-259``). ``reverse``
    ships a receive-layout buffer back so each shard gets chunks in its
    own send layout (the affinity's return trip, ``:262-284``)."""
    n = send.shape[0]
    tail = tuple(send.shape[2:])
    if not plan.dist_widths:
        B, D = plan.boundary, plan.n_shards
        recv = mesh.all_to_all(send.reshape((n, D, B) + tail))
        return recv.reshape((n, D * B) + tail)
    parts, off = [], 0
    for r, bk in enumerate(plan.dist_widths):
        if bk == 0:
            continue
        dest = plan.round_perm(r)
        if reverse:
            dest = [dest.index(s) for s in range(plan.n_shards)]
        parts.append(mesh.ppermute(send[:, off:off + bk], dest))
        off += bk
    if not parts:
        return send.new_zeros((n, 0) + tail)
    return torch.cat(parts, dim=1)


def _matched_rounds(req, D):
    """The D·(D−1) ordered peer pairs as D−1 permutation rounds by
    repeated max-weight perfect matching (``spmm_shard.py:287-310``)."""
    import scipy.optimize as so

    w = np.array([[len(req[d][s]) for d in range(D)] for s in range(D)],
                 np.int64)
    BIG = int(w.sum()) + 1
    used = np.zeros((D, D), bool)
    np.fill_diagonal(used, True)
    rounds = []
    for _ in range(D - 1):
        cost = np.where(used, BIG, -w)
        rs, cs = so.linear_sum_assignment(cost)
        perm = np.empty(D, np.int64)
        perm[rs] = cs
        rounds.append([int(perm[s]) for s in range(D)])
        used[rs, perm[rs]] = True
    return rounds


def build_halo_plan(part: EdgePartition, schedule: str = "dense") -> HaloPlan:
    """Host-side: per-peer boundary sets and the edge remap
    (``spmm_shard.py:313-435``). ``schedule``: ``"dense"``, ``"ring"`` or
    ``"sched"`` (matched rounds, kept only when they ship fewer rows than
    the ring); at D = 1 all three are ``dense``."""
    D, E, R = part.n_shards, part.e_shard, part.rows_per_shard
    col = part.col.numpy()
    val = part.val.numpy()

    req = [[np.zeros(0, np.int64)] * D for _ in range(D)]
    B = 1
    for d in range(D):
        live = val[d] != 0
        owner = col[d] // R
        for s in range(D):
            if s == d:
                continue
            u = np.unique(col[d][live & (owner == s)])
            req[d][s] = u
            B = max(B, len(u))

    if schedule in ("ring", "sched") and D == 1:
        schedule = "dense"
    if schedule in ("ring", "sched"):
        def round_widths(perms):
            return [max(len(req[p[s]][s]) for s in range(D))
                    for p in perms]

        ring_perms = [[(s + k) % D for s in range(D)] for k in range(1, D)]
        perms, dist_perms = ring_perms, ()
        if schedule == "sched" and D > 2:
            cand = _matched_rounds(req, D)
            if sum(round_widths(cand)) < sum(round_widths(ring_perms)):
                perms, dist_perms = cand, tuple(tuple(p) for p in cand)
        widths = round_widths(perms)
        if not any(widths):
            widths[0] = 8   # degenerate block-diagonal graph
        offsets = np.zeros(len(perms), np.int64)
        acc = 0
        for r in range(len(perms)):
            offsets[r] = acc
            acc += widths[r]
        W = acc

        send_idx = np.zeros((D, W), np.int64)
        for r, p in enumerate(perms):
            o = offsets[r]
            for s in range(D):
                u = req[p[s]][s]
                send_idx[s, o: o + len(u)] = u - s * R

        col_remap = np.full((D, E), W, np.int64)
        for d in range(D):
            live = val[d] != 0
            owner = col[d] // R
            m = live & (owner == d)
            col_remap[d, m] = W + (col[d][m] - d * R)
            for r, p in enumerate(perms):
                s = list(p).index(d)   # the source sending to d in round r
                if s == d:
                    continue
                m = live & (owner == s)
                if not m.any():
                    continue
                col_remap[d, m] = offsets[r] + np.searchsorted(
                    req[d][s], col[d][m])
        dist_widths = tuple(int(w) for w in widths)
    elif schedule == "dense":
        send_idx = np.zeros((D, D, B), np.int64)
        for d in range(D):
            for s in range(D):
                if s == d:
                    continue
                u = req[d][s]
                send_idx[s, d, : len(u)] = u - s * R
        send_idx = send_idx.reshape(D, D * B)

        col_remap = np.full((D, E), D * B, np.int64)
        for d in range(D):
            live = val[d] != 0
            owner = col[d] // R
            m = live & (owner == d)
            col_remap[d, m] = D * B + (col[d][m] - d * R)
            for s in range(D):
                if s == d:
                    continue
                m = live & (owner == s)
                if not m.any():
                    continue
                col_remap[d, m] = s * B + np.searchsorted(req[d][s],
                                                          col[d][m])
        dist_widths = ()
        dist_perms = ()
    else:
        raise ValueError(f"unknown halo schedule: {schedule!r}")

    den = np.zeros(part.n_pad, np.float32)
    np.add.at(den, col.reshape(-1), val.reshape(-1))
    return HaloPlan(send_idx=_t(send_idx), col_remap=_t(col_remap),
                    den=_t(den.reshape(D, R)), n_shards=D, boundary=B,
                    rows_per_shard=R, dist_widths=dist_widths,
                    dist_perms=dist_perms)


def place_halo_plan(plan: HaloPlan, mesh) -> HaloPlan:
    return _place(plan, mesh)


def halo_comm_stats(plan: HaloPlan, feat_dim: int,
                    dtype_bytes: int = 4) -> dict:
    """Per-shard, per-call wire volume of the halo schedule against the
    full all-gather (``spmm_shard.py:449-468``)."""
    D, B, R = plan.n_shards, plan.boundary, plan.rows_per_shard
    if plan.dist_widths:
        wire_rows = int(sum(plan.dist_widths))
    else:
        wire_rows = (D - 1) * B
    return {
        "n_shards": D,
        "boundary_rows": B,
        "wire_rows": wire_rows,
        "schedule": ("sched" if plan.dist_perms
                     else "ring" if plan.dist_widths else "dense"),
        "spmm_halo_bytes": wire_rows * feat_dim * dtype_bytes,
        "affinity_halo_bytes": wire_rows * (feat_dim + 1) * dtype_bytes
        + D * R * dtype_bytes,
        "allgather_bytes": (D - 1) * R * feat_dim * dtype_bytes * D,
    }


def _split_local(plan: HaloPlan, part: EdgePartition):
    """The edges split by column side: (local cols, local vals, remote
    cols, remote vals), ``[n, E]`` each."""
    W = plan.buf_width
    is_local = plan.col_remap >= W
    zero = torch.zeros((), dtype=part.val.dtype, device=part.val.device)
    return (torch.where(is_local, plan.col_remap - W, 0),
            torch.where(is_local, part.val, zero),
            torch.where(is_local, 0, plan.col_remap),
            torch.where(is_local, zero, part.val))


def spmm_halo(part: EdgePartition, plan: HaloPlan, h: torch.Tensor,
              mesh) -> torch.Tensor:
    """out = A @ h moving only boundary rows (``spmm_shard.py:471-528``):
    ``h [n, R, d]`` → ``[n, R, d]``. The local-column term does not
    depend on the received buffer. With ``edge_chunks > 1`` the edges
    run in chunks, each recomputed in the backward, so the gathered block
    stays ``[E / chunks, d]``."""
    R = plan.rows_per_shard
    buf = _halo_exchange(plan, _rows(h, plan.send_idx), mesh)
    lc, lv, rc, rv = _split_local(plan, part)

    def add_chunk(out, h, buf, rl, lc, lv, rc, rv):
        out = out + _segment_sum(_rows(h, lc) * lv[..., None], rl, R)
        return out + _segment_sum(_rows(buf, rc) * rv[..., None], rl, R)

    C = part.edge_chunks
    if C == 1:
        return add_chunk(0.0, h, buf, part.row_local, lc, lv, rc, rv)
    out = torch.zeros_like(h)
    step = part.row_local.shape[1] // C
    for c in range(C):
        sl = slice(c * step, (c + 1) * step)
        out = checkpoint(add_chunk, out, h, buf, part.row_local[:, sl],
                         lc[:, sl], lv[:, sl], rc[:, sl], rv[:, sl],
                         use_reentrant=False)
    return out


def affinity_halo(part: EdgePartition, plan: HaloPlan, emb: torch.Tensor,
                  mesh) -> torch.Tensor:
    """Per-node local affinity with the boundary exchange
    (``spmm_shard.py:732-770``): normalized rows ride the exchange out,
    per-column partial sums ride it back to their owner. Returns the
    replicated ``[D·R]`` vector."""
    R, W = plan.rows_per_shard, plan.buf_width
    # the zero-norm guard inside l2_normalize_rows keeps the padding
    # rows from turning the gradient into NaN (spmm_shard.py:741-746)
    emb_n = l2_normalize_rows(emb)
    recv = _halo_exchange(plan, _rows(emb_n, plan.send_idx), mesh)
    buf = torch.cat([recv, emb_n], dim=1)
    cos = ((_rows(emb_n, part.row_local) * _rows(buf, plan.col_remap))
           .sum(-1) * part.val)
    partial = _segment_sum(cos, plan.col_remap, W + R)
    rev = _halo_exchange(plan, partial[:, :W], mesh, reverse=True)
    num = partial[:, W:] + _segment_sum(rev, plan.send_idx, R)
    return mesh.all_gather(num * _inverse(plan.den))


# --------------------------------------------------------------------------
# Per-shard rectangular tile sets (K1 and K2)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloBCSR:
    """Per-shard tile sets of the remapped edge blocks
    (``spmm_shard.py:531-564``), one entry a shard: ``loc``/``locT`` the
    local-column block ``[R × R]`` and its transpose, ``fwd``/``bwd`` the
    remote block ``[R × W]`` and its transpose. The local product does
    not read the received buffer."""

    loc: tuple
    locT: tuple
    fwd: tuple
    bwd: tuple
    r_row_pad: int
    r_col_pad: int
    w_row_pad: int
    w_col_pad: int

    def local_pair(self, i: int) -> BCSRPair:
        return BCSRPair(fwd=self.loc[i], bwd=self.locT[i],
                        n_nodes=self.r_row_pad)

    def remote_pair(self, i: int) -> BCSRPair:
        return BCSRPair(fwd=self.fwd[i], bwd=self.bwd[i],
                        n_nodes=self.r_row_pad)


def _is_bf16(dtype) -> bool:
    return storage_dtype(dtype) == torch.bfloat16


def build_halo_bcsr(part: EdgePartition, plan: HaloPlan, dtype="float32",
                    tile_rows: Optional[int] = None,
                    mem_budget_bytes: int = 8 << 30) -> Optional[HaloBCSR]:
    """Host-side per-shard rectangular tile sets (``spmm_shard.py:567-668``)
    in ``dtype``. ``tile_rows=None`` picks the height on the remapped
    coordinates (``pick_tile_rows``).

    Returns None, and says so on stderr, when the four sets would need
    more than ``mem_budget_bytes``: the caller then takes the ELL route.
    That is decided from the occupancy before anything is built."""
    D, E, R, W = (part.n_shards, part.e_shard, part.rows_per_shard,
                  plan.buf_width)
    rl = part.row_local.numpy()
    cr = plan.col_remap.numpy()
    vv = part.val.numpy()

    # occupancy over the per-shard remapped blocks: shard d's rows offset
    # by d·R_pad so tiles never merge across shards
    live = vv.reshape(-1) != 0
    r_off = _round_up(R, 512)
    rows_all = (rl + (np.arange(D) * r_off)[:, None]).reshape(-1)[live]
    cols_all = cr.reshape(-1)[live]
    if tile_rows is None:
        tile_rows = pick_tile_rows(rows_all, cols_all, D * r_off)
    # the remapped columns span the combined [recv ‖ local] buffer
    n_ct = _round_up(max(W + R, TILE), TILE) // TILE
    occ = np.unique((rows_all // tile_rows).astype(np.int64) * n_ct
                    + cols_all // TILE).shape[0]
    itemsize = 2 if _is_bf16(dtype) else 4
    est_bytes = 4 * occ * tile_rows * TILE * itemsize   # 4 tile sets
    if est_bytes > mem_budget_bytes:
        print(f"[halo] BCSR tile store would need ~{est_bytes / 2**30:.0f}"
              f" GiB ({occ} occupied tiles @ {tile_rows}-tall), over the"
              f" {mem_budget_bytes / 2**30:.0f} GiB budget; taking the ELL"
              f" route", file=sys.stderr, flush=True)
        return None

    def rect(row, col, v, n_rows, n_cols):
        return bcsr_rect_from_coo(row, col, v, n_rows, n_cols, dtype=dtype,
                                  tile_rows=tile_rows, device=HOST)

    loc, locT, fwd, bwd = [], [], [], []
    for d in range(D):
        is_local = cr[d] >= W
        lc = np.where(is_local, cr[d] - W, 0)
        lv = np.where(is_local, vv[d], 0.0).astype(np.float32)
        rv = np.where(is_local, 0.0, vv[d]).astype(np.float32)
        loc.append(rect(rl[d], lc, lv, R, R))
        locT.append(rect(lc, rl[d], lv, R, R))
        fwd.append(rect(rl[d], cr[d], rv, R, W))
        bwd.append(rect(cr[d], rl[d], rv, W, R))
    return HaloBCSR(loc=tuple(loc), locT=tuple(locT), fwd=tuple(fwd),
                    bwd=tuple(bwd),
                    r_row_pad=loc[0].n_rows, r_col_pad=loc[0].n_cols,
                    w_row_pad=bwd[0].n_rows, w_col_pad=fwd[0].n_cols)


def place_halo_bcsr(tiles: HaloBCSR, mesh) -> HaloBCSR:
    return _place(tiles, mesh)


def spmm_halo_bcsr(part: EdgePartition, plan: HaloPlan, tiles: HaloBCSR,
                   h: torch.Tensor, mesh) -> torch.Tensor:
    """out = A @ h: the boundary exchange, then per shard K1 on the local
    pair over its own rows and K1 on the remote pair over the received
    buffer (``spmm_shard.py:693-729``). Two K1 launches a shard forward,
    two backward."""
    R = plan.rows_per_shard
    buf = _halo_exchange(plan, _rows(h, plan.send_idx), mesh)
    return torch.stack([
        bcsr_spmm_rect(tiles.local_pair(i), h[i], R)
        + bcsr_spmm_rect(tiles.remote_pair(i), buf[i], R)
        for i in range(h.shape[0])])


def affinity_halo_bcsr(part: EdgePartition, plan: HaloPlan,
                       tiles: HaloBCSR, emb: torch.Tensor,
                       mesh) -> torch.Tensor:
    """:func:`affinity_halo` with the numerators in K2 on the local pair
    and on the remote pair over the received rows
    (``spmm_shard.py:773-821``); replicated ``[D·R]``."""
    R = plan.rows_per_shard
    emb_n = l2_normalize_rows(emb)
    recv = _halo_exchange(plan, _rows(emb_n, plan.send_idx), mesh)
    n = emb.shape[0]
    num = torch.stack([
        bcsr_sddmm_colsum_rect(tiles.local_pair(i), emb_n[i], emb_n[i])
        for i in range(n)])
    partial = torch.stack([
        bcsr_sddmm_colsum_rect(tiles.remote_pair(i), recv[i], emb_n[i])
        for i in range(n)])
    rev = _halo_exchange(plan, partial, mesh, reverse=True)
    num = num + _segment_sum(rev, plan.send_idx, R)
    return mesh.all_gather(num * _inverse(plan.den))


# --------------------------------------------------------------------------
# ELL halo path (tile-sparse shards)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloELL:
    """Per-shard flat ELL tables of the remapped block
    (``spmm_shard.py:828-857``): ``fwd`` maps ``[recv ‖ local]`` (W + R
    rows) onto the shard's R rows, ``bwd`` is its transpose. K is the same
    on every shard."""

    fwd: tuple
    bwd: tuple
    r_rows: int   # R
    b_rows: int   # W + R

    def pair(self, i: int) -> ELLPair:
        return ELLPair(fwd=self.fwd[i], bwd=self.bwd[i], n_nodes=self.r_rows)


def build_halo_ell(part: EdgePartition, plan: HaloPlan,
                   dtype="float32") -> HaloELL:
    """Host-side per-shard tables (``spmm_shard.py:860-909``): each
    orientation at the largest of the shards' own cost-model K."""
    D, E, R, W = (part.n_shards, part.e_shard, part.rows_per_shard,
                  plan.buf_width)
    rl = part.row_local.numpy()
    cr = plan.col_remap.numpy()
    vv = part.val.numpy()

    def build(rows, cols, vals, n_rows, k=None) -> ELL:
        live = vals != 0
        return ell_from_coo(rows[live], cols[live], vals[live], n_rows,
                            dtype=dtype, k=k, device=HOST)

    kf = max(build(rl[d], cr[d], vv[d], R).k for d in range(D))
    kb = max(build(cr[d], rl[d], vv[d], W + R).k for d in range(D))
    return HaloELL(
        fwd=tuple(build(rl[d], cr[d], vv[d], R, k=kf) for d in range(D)),
        bwd=tuple(build(cr[d], rl[d], vv[d], W + R, k=kb)
                  for d in range(D)),
        r_rows=R, b_rows=W + R)


def place_halo_ell(ells: HaloELL, mesh) -> HaloELL:
    return _place(ells, mesh)


def spmm_halo_ell(part: EdgePartition, plan: HaloPlan, ells: HaloELL,
                  h: torch.Tensor, mesh) -> torch.Tensor:
    """out = A @ h: the boundary exchange, then per shard the ELL product
    over ``[recv ‖ local]``, its backward on the transposed table
    (``spmm_shard.py:918-951``)."""
    buf = _halo_exchange(plan, _rows(h, plan.send_idx), mesh)
    combined = torch.cat([buf, h], dim=1)
    return torch.stack([ell_spmm(ells.pair(i), combined[i])
                        for i in range(h.shape[0])])


# --------------------------------------------------------------------------
# Subset affinity and seed-row aggregation
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloAffinitySubset:
    """The affinity restricted to a fixed column subset (GGAD's margin
    reads it only at the labeled nodes; ``spmm_shard.py:958-1003``). Each
    shard keeps its edges whose columns are in the subset; ``row_local``,
    ``col_sub`` (the column's position in ``uniq``) and ``val`` are
    ``[D, E_sub]``. ``uniq``, ``gather`` and ``den`` are replicated.
    ``t_fwd``/``t_bwd``: optional per-shard rect tile sets of the
    restricted ``[R × U]`` block and its transpose (K2 then computes the
    numerator)."""

    row_local: torch.Tensor   # int64
    col_sub: torch.Tensor     # int64
    val: torch.Tensor         # float32
    uniq: torch.Tensor        # [U] int64, sorted global ids
    gather: torch.Tensor      # [S] position of idx[k] in uniq
    den: torch.Tensor         # [U] column sums of val
    n_uniq: int
    e_sub: int
    t_fwd: Optional[tuple] = None
    t_bwd: Optional[tuple] = None

    def pair(self, i: int) -> BCSRPair:
        return BCSRPair(fwd=self.t_fwd[i], bwd=self.t_bwd[i],
                        n_nodes=self.t_fwd[i].n_rows)


def build_halo_affinity_subset(part: EdgePartition, idx,
                               tiles_dtype=None) -> HaloAffinitySubset:
    """Host-side: ``part``'s edges restricted to the columns in ``idx``
    (``spmm_shard.py:1006-1097``); ``tiles_dtype`` also builds the
    per-shard rect tile sets in that dtype."""
    D, E, R = part.n_shards, part.e_shard, part.rows_per_shard
    idx = np.asarray(idx, np.int64)
    uniq, gather = np.unique(idx, return_inverse=True)
    U = len(uniq)
    lookup = np.full(part.n_pad, -1, np.int64)
    lookup[uniq] = np.arange(U)

    rl = part.row_local.numpy()
    cc = part.col.numpy()
    vv = part.val.numpy()
    blocks = []
    e_sub = 0
    den = np.zeros(U, np.float32)
    for d in range(D):
        live = (vv[d] != 0) & (lookup[cc[d]] >= 0)
        r, c, v = rl[d][live], lookup[cc[d][live]], vv[d][live]
        np.add.at(den, c, v)
        blocks.append((r, c, v))
        e_sub = max(e_sub, len(r))
    e_sub = max(_round_up(e_sub, 8), 8)

    rs = np.zeros((D, e_sub), np.int64)
    cs = np.zeros((D, e_sub), np.int64)
    vs = np.zeros((D, e_sub), np.float32)
    for d, (r, c, v) in enumerate(blocks):
        rs[d, : len(r)] = r
        cs[d, : len(c)] = c
        vs[d, : len(v)] = v

    tile_kw: dict = {}
    if tiles_dtype is not None:
        r_off = _round_up(R, 1024)
        rows_all = np.concatenate(
            [b[0] + d * r_off for d, b in enumerate(blocks)])
        cols_all = np.concatenate([b[1] for b in blocks])
        tr = pick_tile_rows(rows_all, cols_all, D * r_off)
        tile_kw = dict(
            t_fwd=tuple(bcsr_rect_from_coo(b[0], b[1], b[2], R, U,
                                           dtype=tiles_dtype, tile_rows=tr,
                                           device=HOST) for b in blocks),
            t_bwd=tuple(bcsr_rect_from_coo(b[1], b[0], b[2], U, R,
                                           dtype=tiles_dtype, tile_rows=tr,
                                           device=HOST) for b in blocks))
    return HaloAffinitySubset(
        row_local=_t(rs), col_sub=_t(cs), val=_t(vs), uniq=_t(uniq),
        gather=_t(gather.astype(np.int64)), den=_t(den), n_uniq=U,
        e_sub=e_sub, **tile_kw)


def place_halo_affinity_subset(sub: HaloAffinitySubset,
                               mesh) -> HaloAffinitySubset:
    return _place(sub, mesh, replicated=("uniq", "gather", "den"))


def affinity_halo_subset(plan: HaloPlan, sub: HaloAffinitySubset,
                         emb: torch.Tensor, mesh) -> torch.Tensor:
    """The affinity at the k-th requested node, the values of
    ``affinity_halo(...)[idx]``, with two small ``psum``s in place of the
    boundary exchange (``spmm_shard.py:1119-1183``): each shard puts the
    normalized target rows it owns in a replicated ``[U, d]``, computes
    its numerator partials over its restricted edges (K2 on its rect
    tiles when the subset has them) and one ``psum`` adds them. Returns
    the replicated ``[S]``. Of ``plan`` only ``rows_per_shard`` is read,
    so the partition serves as well."""
    R, U = plan.rows_per_shard, sub.n_uniq
    # zero-norm guard inside l2_normalize_rows (spmm_shard.py:1133-1137)
    emb_n = l2_normalize_rows(emb)
    loc = sub.uniq[None, :] - _my(mesh)[:, None] * R
    own = (loc >= 0) & (loc < R)
    tgt = mesh.pvary(mesh.psum(torch.where(
        own[..., None], _rows(emb_n, loc.clamp(0, R - 1)),
        torch.zeros((), dtype=emb_n.dtype, device=emb_n.device))))
    if sub.t_fwd is not None:
        partial = torch.stack([
            bcsr_sddmm_colsum_rect(sub.pair(i), tgt, emb_n[i])
            for i in range(emb.shape[0])])
    else:
        cos = ((_rows(emb_n, sub.row_local) * _take(tgt, sub.col_sub))
               .sum(-1)
               * sub.val)
        partial = _segment_sum(cos, sub.col_sub, U)
    aff = mesh.psum(partial) * _inverse(sub.den)
    return _take(aff, sub.gather)


@dataclasses.dataclass(frozen=True)
class HaloSeedRows:
    """The seed rows' edges bucketed by column owner, for
    ``(A @ emb)[seed]`` (``spmm_shard.py:1186-1206``): ``seed_pos`` (the
    edge's row in the seed list), ``col_local`` and ``val`` are
    ``[D, E_seed]``."""

    seed_pos: torch.Tensor   # int64
    col_local: torch.Tensor  # int64
    val: torch.Tensor        # float32
    n_seed: int
    e_seed: int


def build_halo_seed_rows(part: EdgePartition, seed_idx) -> HaloSeedRows:
    """Host-side: bucket the seed rows' edges by column owner
    (``spmm_shard.py:1209-1250``)."""
    D, E, R = part.n_shards, part.e_shard, part.rows_per_shard
    seed_idx = np.asarray(seed_idx, np.int64)
    S = len(seed_idx)
    lookup = np.full(part.n_pad, -1, np.int64)
    lookup[seed_idx] = np.arange(S)

    rl = part.row_local.numpy()
    cc = part.col.numpy()
    vv = part.val.numpy()
    rows_g = np.concatenate([rl[d] + d * R for d in range(D)])
    cols = cc.reshape(-1)
    vals = vv.reshape(-1)
    live = (vals != 0) & (lookup[rows_g] >= 0)
    pos, cols, vals = lookup[rows_g[live]], cols[live], vals[live]
    owner = cols // R

    blocks = []
    e_seed = 0
    for d in range(D):
        m = owner == d
        blocks.append((pos[m], cols[m] - d * R, vals[m]))
        e_seed = max(e_seed, int(m.sum()))
    e_seed = max(_round_up(e_seed, 8), 8)

    ps = np.zeros((D, e_seed), np.int64)
    cs = np.zeros((D, e_seed), np.int64)
    vs = np.zeros((D, e_seed), np.float32)
    for d, (p, c, v) in enumerate(blocks):
        ps[d, : len(p)] = p
        cs[d, : len(c)] = c
        vs[d, : len(v)] = v
    return HaloSeedRows(seed_pos=_t(ps), col_local=_t(cs), val=_t(vs),
                        n_seed=S, e_seed=e_seed)


def place_halo_seed_rows(sub: HaloSeedRows, mesh) -> HaloSeedRows:
    return _place(sub, mesh)


def spmm_halo_seed_rows(sub: HaloSeedRows, emb: torch.Tensor,
                        mesh) -> torch.Tensor:
    """``(A @ emb)[seed]`` as per-shard column partials and one ``psum``
    (``spmm_shard.py:1263-1279``); the replicated ``[S, d]``."""
    gathered = _rows(emb, sub.col_local) * sub.val[..., None]
    return mesh.psum(_segment_sum(gathered, sub.seed_pos, sub.n_seed))
