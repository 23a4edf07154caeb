"""TAM, truncated affinity maximization (counterpart of
``ggad_tpu/models/tam.py``).

Reference (``tam.py``, ``model_tam.py``, ``utils_tam.py``):
  * per-edge feature distances (:func:`edge_feature_distance`);
  * NSGT truncation per round: for each row, a threshold drawn from
    U(global-mean-distance, row-max-distance) cuts the edges whose
    distance exceeds it; the cut graph is symmetrised by union
    (:func:`nsgt_cut`);
  * per round, a fresh 2-layer GCN (n_in → 2·n_h → n_h) maximises the
    min-max normalised 1-hop affinity of the labeled normals on the RAW
    graph (:func:`tam_loss`), Adam lr 1e-5, 500 epochs;
  * score = 1 − minmax(mean over rounds of the per-round affinity).

Every (cutting × n_tree) member is the raw graph with other edge values,
so the members train together as one ensemble with stacked parameters
(:class:`TAMEnsemble`: ``[M, out, in]`` weights, ``[M, out]`` biases,
``[M]`` alphas, one Adam, which is elementwise with one shared step
count and so is per-member Adam). Each layer's aggregation takes one of
two routes (:func:`tam_route`, decided by the graph alone):

  * ``"bcsr"`` (tile-dense graphs): one K1 launch over the block-diagonal
    tile pair diag(Â_1..Â_M) (:func:`blockdiag_pair`), forward and, on
    the transposed pair, backward;
  * ``"ell"`` (tile-sparse graphs): each member's values on the shared
    flat ELL tables of the raw graph (``ell_value_maps`` /
    ``ell_remap_values``), one product a member.

The affinity runs on the raw graph's flat ELL tables on both routes, so
TAM launches no K2. A block-diagonal failure raises; it does not reroute
to ELL.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.nn.layers import GCNLayer
from ggad_tpu_torch.ops.bcsr_spmm import (
    BCSR,
    TILE,
    BCSRPair,
    _round_up,
    bcsr_spmm,
    pick_tile_rows,
)
from ggad_tpu_torch.ops.ell_spmm import (
    ELLPair,
    as_ell_graph,
    ell_remap_values,
    ell_spmm,
    ell_value_maps,
)
from ggad_tpu_torch.ops.sddmm import node_affinity

TAM_ROUTES = ("bcsr", "ell")
# auto takes the block-diagonal route at this many edges an occupied
# 128×128 tile (``tam.py:429-436``)
MIN_EDGES_PER_TILE = 8.0
# tile stores (forward + transposed) of one member chunk (``tam.py:223-227``)
BCSR_BUDGET_BYTES = 4 << 30


class TAMEncoder(nn.Module):
    """gcn1 (n_in → 2·n_h) → gcn2 (2·n_h → n_h), PReLU on both (reference
    ``model_tam.py:233-239``); the reference's fc1/fc2 heads feed only
    commented-out regularisers and are not carried. One member; the
    ensemble trains stacked copies of its parameters."""

    def __init__(self, in_features: int, n_h: int = 300, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gcn1 = GCNLayer(in_features, 2 * n_h, act="prelu",
                             generator=generator)
        self.gcn2 = GCNLayer(2 * n_h, n_h, act="prelu", generator=generator)

    def forward(self, adj, x: torch.Tensor) -> torch.Tensor:
        return self.gcn2(adj, self.gcn1(adj, x))


def edge_feature_distance(g, x: torch.Tensor) -> torch.Tensor:
    """dis_e = ‖x_row − x_col‖₂ per edge, 0 on padding edges (reference
    ``calc_distance``, ``utils_tam.py:190-199``)."""
    d = (x[g.row] - x[g.col]).square().sum(1).sqrt()
    return torch.where(g.val != 0, d, d.new_zeros(()))


def transpose_permutation(g) -> np.ndarray:
    """Host-side: the permutation p with (row[p[e]], col[p[e]]) ==
    (col[e], row[e]) for a structurally symmetric edge list; padding edges
    map to themselves."""
    row = g.row.cpu().numpy()
    col = g.col.cpu().numpy()
    e = g.n_edges
    fwd = np.lexsort((col[:e], row[:e]))
    bwd = np.lexsort((row[:e], col[:e]))
    perm = np.arange(g.e_pad)
    perm[fwd] = bwd
    return perm


def nsgt_cut(val: torch.Tensor, dis: torch.Tensor, g, t_perm: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """One NSGT truncation round on edge values (0 = cut), with the
    round's uniform draw ``u [N]`` given.

    Per row i: thresh_i = mean_dis + (max_dis_i − mean_dis)·u_i; edges with
    dis > thresh_i are cut (only in rows where max_dis_i > mean_dis); then
    the union symmetrisation val' = max(val_cut, val_cut[transpose]).
    """
    live = val != 0
    zero = dis.new_zeros(())
    mean_dis = (torch.where(live, dis, zero).sum()
                / live.sum().clamp_min(1))
    row_max = torch.full((g.n_nodes,), -torch.inf, dtype=dis.dtype,
                         device=dis.device).scatter_reduce(
        0, g.row, torch.where(live, dis, -torch.inf), "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max, zero)
    thresh = mean_dis + (row_max - mean_dis) * u
    active = row_max > mean_dis
    cut = live & active[g.row] & (dis > thresh[g.row])
    new_val = torch.where(cut, zero, val)
    return torch.maximum(new_val, new_val[t_perm])


def sym_normalize_vals(val: torch.Tensor, g) -> torch.Tensor:
    """D^{-1/2} A D^{-1/2} on edge values ``[..., E_pad]`` (column-sum
    degrees, as the reference's ``normalize_adj_tensor``; the same for a
    symmetric graph). A stack ``[M, E_pad]`` normalises each member."""
    deg = val.new_zeros(val.shape[:-1] + (g.n_nodes,)).index_add_(
        -1, g.col, val)
    inv = torch.where(deg > 0, deg.rsqrt(), deg.new_zeros(()))
    return val * inv[..., g.row] * inv[..., g.col]


def minmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """(x − min) / max(max − min, 1e-12) along ``dim``."""
    lo = x.amin(dim, keepdim=True)
    hi = x.amax(dim, keepdim=True)
    return (x - lo) / (hi - lo).clamp_min(1e-12)


def tam_loss(emb: torch.Tensor, raw_adj,
             normal_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, message): the negated sum of the min-max normalised affinity
    of the labeled normals on the raw graph (reference ``max_message``,
    ``tam.py:113-133``)."""
    message = node_affinity(raw_adj, emb)
    return -minmax(message)[normal_idx].sum(), message


@dataclasses.dataclass
class TAMResult:
    scores: np.ndarray            # final ensemble score, 1 − minmax(mean)
    per_round_scores: np.ndarray  # [rounds, N]
    member_messages: Optional[np.ndarray] = None  # [M, N] last-epoch raw
                                  # affinity per member (reference
                                  # message_sum, tam.py:192-201)
    loss_history: Optional[dict] = None  # epoch -> [M] per-member
                                  # pre-update losses (with loss_record)


# ---------------------------------------------------------------------------
# The block-diagonal tile pair (the BCSR route)
# ---------------------------------------------------------------------------

def _blockdiag_bcsr(row: np.ndarray, col: np.ndarray, vs: np.ndarray,
                    n_nodes: int, tile_rows: int, device) -> BCSR:
    """Tile store of diag(A_1..A_M), where the A_m share the sparsity
    (row, col) and member m's edge values are ``vs[m]``. Both spaces pad
    to one per-member stride P = round_up(N, tile_rows), so [h_1 ‖ … ‖ h_M]
    packs and unpacks with one reshape; member m's tiles are the shared
    tile keys offset by m, which keeps the (tile_row, tile_col) order.
    Values are summed with ``np.add.at`` in f32, as ``bcsr_from_coo``
    sums duplicate edges; a cut edge stores 0, which the compressed rows
    drop."""
    n_members = vs.shape[0]
    p_pad = _round_up(max(n_nodes, tile_rows), tile_rows)
    nrt, nct = p_pad // tile_rows, p_pad // TILE
    tkey = (row // tile_rows) * nct + col // TILE
    uniq, inv = np.unique(tkey, return_inverse=True)
    t = len(uniq)
    m = np.arange(n_members)[:, None]
    rows_bd = (uniq // nct + m * nrt).reshape(-1).astype(np.int32)
    cols_bd = (uniq % nct + m * nct).reshape(-1).astype(np.int32)
    values = np.zeros((n_members * t, tile_rows, TILE), np.float32)
    rr, cc = row % tile_rows, col % TILE
    for mi in range(n_members):
        np.add.at(values, (mi * t + inv, rr, cc), vs[mi])
    t_ptr = np.searchsorted(
        rows_bd, np.arange(n_members * nrt + 1)).astype(np.int32)
    return BCSR(tile_rows=torch.from_numpy(rows_bd).to(device),
                tile_cols=torch.from_numpy(cols_bd).to(device),
                tile_ptr=torch.from_numpy(t_ptr).to(device),
                values=torch.from_numpy(values).to(device),
                n_rows=n_members * p_pad, n_cols=n_members * p_pad)


def blockdiag_pair(g, val_stack: torch.Tensor, tile_rows: int) -> BCSRPair:
    """The :class:`BCSRPair` of diag(A_1..A_M) on ``g``'s device, with
    member m's edge values ``val_stack[m]`` (``[M, E_pad]``, ``g``'s edge
    order), and of its transpose; built on the host (``tam.py:146-196``).
    """
    e = g.n_edges
    row = g.row[:e].cpu().numpy()
    col = g.col[:e].cpu().numpy()
    vs = val_stack[:, :e].detach().float().cpu().numpy()
    fwd = _blockdiag_bcsr(row, col, vs, g.n_nodes, tile_rows, g.device)
    bwd = _blockdiag_bcsr(col, row, vs, g.n_nodes, tile_rows, g.device)
    return BCSRPair(fwd=fwd, bwd=bwd, n_nodes=fwd.n_rows)


def blockdiag_aggregate(pair: BCSRPair, n_nodes: int
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[M, N, w] ↦ [Â_m h_m]_m through one K1 launch on the block-diagonal
    ``pair`` (its backward one more, on the transposed pair)."""
    p_pad = _round_up(n_nodes, pair.fwd.tile_height)
    m = pair.fwd.n_rows // p_pad

    def aggregate(hw: torch.Tensor) -> torch.Tensor:
        w = hw.shape[-1]
        hp = F.pad(hw, (0, 0, 0, p_pad - n_nodes)).reshape(m * p_pad, w)
        return bcsr_spmm(pair, hp).view(m, p_pad, w)[:, :n_nodes]

    return aggregate


# ---------------------------------------------------------------------------
# The shared ELL tables (the ELL route)
# ---------------------------------------------------------------------------

def member_tables(raw_ell, maps, norm_stack: torch.Tensor) -> list[ELLPair]:
    """Each member's tables: the raw graph's flat tables with the member's
    value planes (``tam.py:481-528``). ``maps`` is the (forward, transposed)
    :class:`~ggad_tpu_torch.ops.ell_spmm.ELLValueMap` pair."""
    fmap, bmap = maps
    out = []
    for v in norm_stack:
        fv, fov = ell_remap_values(fmap, v)
        bv, bov = ell_remap_values(bmap, v)
        out.append(ELLPair(
            fwd=dataclasses.replace(raw_ell.tables.fwd, val=fv, ov_val=fov),
            bwd=dataclasses.replace(raw_ell.tables.bwd, val=bv, ov_val=bov),
            n_nodes=raw_ell.n_nodes))
    return out


def ell_value_map_pair(raw_ell):
    """The raw graph's edge → slot maps into its forward and transposed
    flat tables."""
    row, col, _ = raw_ell.graph.host_coo()
    t = raw_ell.tables
    return (ell_value_maps(row, col, raw_ell.n_nodes, t.fwd.k,
                           device=raw_ell.device),
            ell_value_maps(row, col, raw_ell.n_nodes, t.bwd.k,
                           transpose=True, device=raw_ell.device))


def tables_aggregate(tables: Sequence[ELLPair]
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[M, N, w] ↦ [Â_m h_m]_m, one ELL product a member."""
    def aggregate(hw: torch.Tensor) -> torch.Tensor:
        return torch.stack([ell_spmm(t, h) for t, h in zip(tables, hw)])

    return aggregate


# ---------------------------------------------------------------------------
# The ensemble
# ---------------------------------------------------------------------------

class TAMEnsemble:
    """A chunk of members training together (``tam.py:199-331``, both
    routes): stacked ``TAMEncoder`` parameters (``params``: the state_dict
    names, a leading member axis on each), one Adam over them, and
    ``aggregate``, the layer's sparse product for all members at once.

    ``step()`` is one epoch: the forward of every member, the affinity on
    the raw graph (``raw_ell``), the loss, one backward and one Adam step.
    The gradients are never zeroed, so each step takes the running sum of
    every epoch's gradients: the reference zeroes them once per member
    (``tam.py:180``, JAX's ``acc``)."""

    def __init__(self, aggregate: Callable, x: torch.Tensor, raw_ell,
                 normal_idx: torch.Tensor, params: Mapping, lr: float):
        self.aggregate = aggregate
        self.x = x
        self.raw_ell = raw_ell
        self.normal_idx = normal_idx
        self.params = {k: v.detach().to(x.device, copy=True)
                       .requires_grad_(True) for k, v in params.items()}
        self.optimizer = torch.optim.Adam(self.params.values(), lr=lr)

    def layer(self, name: str, h: torch.Tensor) -> torch.Tensor:
        p = self.params
        eq = "nf,mhf->mnh" if h.dim() == 2 else "mnf,mhf->mnh"
        hw = torch.einsum(eq, h, p[f"{name}.fc.weight"])
        agg = self.aggregate(hw) + p[f"{name}.bias"][:, None, :]
        alpha = p[f"{name}.prelu.alpha"][:, None, None]
        return torch.where(agg >= 0, agg, alpha * agg)

    def step(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One epoch; the per-member losses ``[M]`` before the update and
        the affinity ``[M, N]`` they were taken from, both detached."""
        emb = self.layer("gcn2", self.layer("gcn1", self.x))
        message = torch.stack([node_affinity(self.raw_ell, e) for e in emb])
        # tam_loss for all members at once: one min-max over the stack
        # (``tam_loss`` a member costs ~300 more device ops an epoch)
        loss_m = -minmax(message)[:, self.normal_idx].sum(1)
        loss_m.sum().backward()
        self.optimizer.step()
        return loss_m.detach(), message.detach()


def init_members(in_features: int, n_h: int, n_members: int,
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Stacked seeded inits: member m is the m-th ``TAMEncoder`` drawn
    from ``generator``."""
    members = [TAMEncoder(in_features, n_h, generator=generator).state_dict()
               for _ in range(n_members)]
    return {k: torch.stack([m[k] for m in members]) for k in members[0]}


def tam_route(raw_adj, impl: Optional[str] = None) -> str:
    """``"bcsr"`` or ``"ell"``. ``None``/``"auto"`` decides by the graph
    alone: at least ``MIN_EDGES_PER_TILE`` edges an occupied 128×128 tile
    takes the block-diagonal route (JAX applies this test on the TPU only
    and takes ELL elsewhere)."""
    if impl in TAM_ROUTES:
        return impl
    if impl not in (None, "auto"):
        raise ValueError(f"TAM's impl is 'bcsr', 'ell' or 'auto', not "
                         f"{impl!r}")
    row, col, _ = raw_adj.host_coo()
    npt = (raw_adj.n_nodes + TILE - 1) // TILE
    tiles = np.unique(row // TILE * npt + col // TILE).shape[0]
    return ("bcsr" if raw_adj.n_edges / max(tiles, 1) >= MIN_EDGES_PER_TILE
            else "ell")


def member_chunk_for(raw_adj, route: str, n_members: int, n_h: int,
                     tile_rows: int = TILE, ell_k: int = 0) -> int:
    """How many members train together when the caller does not say:
    on BCSR as many as ``BCSR_BUDGET_BYTES`` of forward + transposed tile
    stores hold (``tam.py:223-227``), on ELL JAX's slot-buffer rule
    (``tam.py:389-393``)."""
    if route == "bcsr":
        row, col, _ = raw_adj.host_coo()
        nct = _round_up(max(raw_adj.n_nodes, tile_rows), tile_rows) // TILE
        t_est = np.unique(row // tile_rows * nct + col // TILE).shape[0]
        per_member = 2 * t_est * tile_rows * TILE * 4
        return max(1, min(n_members, BCSR_BUDGET_BYTES // per_member))
    slot_bytes = raw_adj.n_nodes * max(2 * n_h, ell_k) * 4
    return max(1, min(n_members, int(4e9 // max(slot_bytes * 6, 1))))


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """``a`` (a tensor or an array) as a ``dtype`` tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def cut_stack(raw_adj, x: torch.Tensor, cutting: int, n_tree: int,
              draws: Iterable) -> torch.Tensor:
    """``[cutting·n_tree, E_pad]`` cut values, sequential in cuts, one
    chain per tree (``tam.py:400-415``); ``draws`` yields each cut's
    uniform ``[N]`` draw in that order."""
    dis = edge_feature_distance(raw_adj, x)
    t_perm = torch.from_numpy(transpose_permutation(raw_adj)).to(
        raw_adj.device)
    draws = iter(draws)
    vals = [raw_adj.val] * n_tree
    out = []
    for _ in range(cutting):
        for t in range(n_tree):
            u = _tensor(next(draws), torch.float32, raw_adj.device)
            vals[t] = nsgt_cut(vals[t], dis, raw_adj, t_perm, u)
            out.append(vals[t])
    return torch.stack(out)


def ensemble_scores(messages: np.ndarray, cutting: int, n_tree: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(final, per-round) scores from the members' messages ``[M, N]``
    (reference ``tam.py:206-237``): the running mean over rounds of the
    per-round mean affinity, min-max normalised in f32, subtracted from
    1."""
    per_cut = messages.reshape(cutting, n_tree, -1).mean(axis=1)
    running = np.cumsum(per_cut, axis=0) / np.arange(
        1, cutting + 1)[:, None]

    def score(r):
        return 1.0 - minmax(torch.from_numpy(r.astype(np.float32))).numpy()

    return score(running[-1]), np.stack([score(r) for r in running])


def run_tam(
    raw_adj,
    features,
    normal_idx,
    *,
    n_h: int = 300,
    cutting: int = 8,
    n_tree: int = 1,
    num_epoch: int = 500,
    lr: float = 1e-5,
    seed: int = 0,
    member_chunk: Optional[int] = None,
    impl: Optional[str] = None,
    verbose: bool = False,
    draws: Optional[Sequence] = None,
    val_stack=None,
    member_params: Optional[Mapping] = None,
    loss_record: Optional[Iterable[int]] = None,
) -> TAMResult:
    """The TAM pipeline (``tam.py:334-606``) on ``raw_adj``'s device:
    ``raw_adj`` is the graph with self-loops (A + I), ``features``
    ``[N, F]`` and ``normal_idx`` the labeled normals (numpy).

    The cut values are ``val_stack`` (``[M, E_pad]`` raw 0/1 values in
    ``raw_adj``'s edge order, JAX's ``val_stack_override``) or are cut
    here from ``draws`` (``cutting·n_tree`` uniform ``[N]`` draws, in cut
    order). The member weights are ``member_params`` (a stacked flax tree
    or state_dict, JAX's ``member_params_override``) or the seeded init:
    member m the m-th ``TAMEncoder`` drawn from ``torch.Generator`` seeded
    with ``seed``, which then draws the cuts' uniforms when ``draws`` is
    not given. ``impl`` picks the route (:func:`tam_route`);
    ``member_chunk`` how many members train together on either route
    (``None``: :func:`member_chunk_for`), which changes no result.
    ``loss_record``: the epochs whose per-member pre-update losses come
    back in ``loss_history``.
    """
    device = raw_adj.device
    x = _tensor(features, torch.float32, device)
    nidx = _tensor(normal_idx, torch.int64, device)
    n_members = cutting * n_tree
    gen = torch.Generator().manual_seed(seed)
    if member_params is None:
        member_params = init_members(x.shape[1], n_h, n_members, gen)
    params = as_state_dict(member_params, device)
    if val_stack is None:
        if draws is None:
            draws = [torch.rand(raw_adj.n_nodes, generator=gen)
                     for _ in range(n_members)]
        val_stack = cut_stack(raw_adj, x, cutting, n_tree, draws)
    else:
        val_stack = _tensor(val_stack, torch.float32, device)
    norm_stack = sym_normalize_vals(val_stack, raw_adj)

    raw_ell = as_ell_graph(raw_adj)
    route = tam_route(raw_adj, impl)
    if route == "bcsr":
        row, col, _ = raw_adj.host_coo()
        tile_rows = pick_tile_rows(row, col, raw_adj.n_nodes)
        chunk = member_chunk or member_chunk_for(
            raw_adj, route, n_members, n_h, tile_rows=tile_rows)
    else:
        maps = ell_value_map_pair(raw_ell)
        chunk = member_chunk or member_chunk_for(
            raw_adj, route, n_members, n_h, ell_k=raw_ell.tables.fwd.k)

    loss_record = None if loss_record is None else list(loss_record)
    messages = []
    hist = {ep: [] for ep in sorted(set(loss_record or ())) if ep < num_epoch}
    for start in range(0, n_members, chunk):
        sl = slice(start, start + chunk)
        if route == "bcsr":
            aggregate = blockdiag_aggregate(
                blockdiag_pair(raw_adj, norm_stack[sl], tile_rows),
                raw_adj.n_nodes)
        else:
            aggregate = tables_aggregate(
                member_tables(raw_ell, maps, norm_stack[sl]))
        ens = TAMEnsemble(aggregate, x, raw_ell, nidx,
                          {k: v[sl] for k, v in params.items()}, lr)
        for ep in range(num_epoch):
            loss_m, message = ens.step()
            if ep in hist:
                hist[ep].append(loss_m.cpu().numpy())
            if verbose and ((ep + 1) % 50 == 0 or ep + 1 == num_epoch):
                print(f"tam[{route}] members {start}+ epoch {ep + 1}: mean "
                      f"loss {float(loss_m.mean()):.4f}", flush=True)
        messages.append(message.cpu().numpy())
        del ens, aggregate      # the chunk's tile pair, before the next's
    messages = np.concatenate(messages)
    final, per_round = ensemble_scores(messages, cutting, n_tree)
    return TAMResult(
        scores=final, per_round_scores=per_round, member_messages=messages,
        loss_history=({ep: np.concatenate(v) for ep, v in hist.items()}
                      if loss_record else None))
