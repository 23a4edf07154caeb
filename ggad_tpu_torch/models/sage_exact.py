"""Exact-mask minibatch GGAD: the reference's set-union aggregation
(counterpart of ``ggad_tpu/models/sage_exact.py``).

The production minibatch path samples a fixed fanout. The reference's
``GCN`` model does not: ``GCNAggregator.forward``
(``src/graphsage.py:295-360``) builds the exact union-of-neighbors mask,
so given the same batch sequence its training is deterministic. This
module replays that computation on padded static shapes, for trajectory
parity against the reference and the sampled-vs-exact two-hop study.

Reference semantics, quirks included (its CPU branch, the one executed):

  * 1-hop: a mask ``[B, U]`` over union(neighbors ∪ self), normalized
    mask/√rowsum/√colsum of the rectangular mask; no self-feature add
    (``src/graphsage.py:325-327`` comments it out).
  * 2-hop (train): the neighbor union of the 1-hop uniq nodes, the same
    normalization; context = (mask/rowsum) @ relu(W · 2-hop features).
  * Reordering: ``combined_all`` is [normals ‖ generated] while the
    labels and the context stay in batch order
    (``src/graphsage.py:171-176,244-246,450``), so a label-1 node
    mid-batch misaligns the score and label rows as the reference's do.
  * torch ``cosine_similarity``'s eps: x·y / max(‖x‖‖y‖, 1e-8).
  * The reference's optimizer is torch ``Adam(weight_decay=wd)``, a
    coupled L2 (JAX rebuilds it as ``coupled_adam``); the port uses
    ``torch.optim.Adam(params, lr, weight_decay=wd)`` itself.

The replay graph is the symmetrized adjacency without self-loops
(:func:`replay_adjacency`; ``scripts/reference_oracle.py:902-909``). The
set unions run on the host (:func:`build_exact_batch`); the dense padded
masks and every product run on the batch's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ggad_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ExactBatch:
    """Padded batch structures (one shape a pad)."""

    nodes: torch.Tensor   # [B] int64 batch node ids
    labels: torch.Tensor  # [B] float32 0/1 (batch order)
    uniq: torch.Tensor    # [U_pad] int64 (0-padded)
    expand: torch.Tensor  # [E_pad] int64 (0-padded)
    mask1: torch.Tensor   # [B, U_pad] 0/1: neighbors ∪ self
    mask2: torch.Tensor   # [U_pad, E_pad] 0/1, rows zero on padding
    perm: torch.Tensor    # [B] int64: stable argsort(labels), normals
    #                       first, anomalies last (the reference's cat)

    def to(self, device: DeviceLike) -> "ExactBatch":
        return ExactBatch(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def replay_adjacency(adj) -> tuple[np.ndarray, np.ndarray]:
    """(indptr, indices) of the symmetrized graph with no self-loop
    added: the reference pickles ``adj_list`` without self-loops (its
    second ``sparse_to_adjlist``, ``src/utils.py:105-112``)."""
    a = sp.csr_matrix(adj)
    sym = ((a + a.T) > 0).tocsr()
    return sym.indptr, sym.indices


def _union_sets(indptr, indices, nodes) -> list[set]:
    return [set(indices[indptr[n]: indptr[n + 1]].tolist()) for n in nodes]


def _set_mask(sets: list[set], pos: dict, shape) -> np.ndarray:
    m = np.zeros(shape, np.float32)
    rows = np.repeat(np.arange(len(sets)), [len(s) for s in sets])
    cols = np.fromiter((pos[n] for s in sets for n in s), np.int64,
                       count=rows.shape[0])
    m[rows, cols] = 1.0
    return m


def build_exact_batch(indptr: np.ndarray, indices: np.ndarray,
                      nodes: np.ndarray, labels: np.ndarray, u_pad: int,
                      e_pad: int, two_hop: bool = True, *,
                      device: DeviceLike = None) -> ExactBatch:
    """The exact union masks of one batch from a CSR adjacency, built on
    the host and placed on ``device``. ``two_hop=False`` (the eval path)
    leaves ``mask2`` zero and ``expand`` empty of ids."""
    device = resolve_device(device)
    nodes = np.asarray(nodes, np.int64)
    neighs = [s | {int(n)} for s, n in
              zip(_union_sets(indptr, indices, nodes), nodes)]
    uniq_list = sorted(set().union(*neighs))
    m1 = _set_mask(neighs, {n: i for i, n in enumerate(uniq_list)},
                   (len(nodes), u_pad))
    exp_list = []
    if two_hop:
        neighs2 = _union_sets(indptr, indices, uniq_list)
        exp_list = sorted(set().union(*neighs2))
        m2 = _set_mask(neighs2, {n: i for i, n in enumerate(exp_list)},
                       (u_pad, e_pad))
    else:
        m2 = np.zeros((u_pad, e_pad), np.float32)
    uniq = np.zeros(u_pad, np.int64)
    uniq[: len(uniq_list)] = uniq_list
    expand = np.zeros(e_pad, np.int64)
    expand[: len(exp_list)] = exp_list
    labels = np.asarray(labels, np.float32)
    perm = np.argsort(labels, kind="stable")
    return ExactBatch(*(torch.from_numpy(a).to(device) for a in (
        nodes, labels, uniq, expand, m1, m2, perm)))


def exact_pads(indptr, indices, batches, multiple: int = 64
               ) -> tuple[int, int]:
    """(U_pad, E_pad): the largest 1-hop and 2-hop unions over ``batches``
    (lists of node ids), each rounded up to ``multiple``: one pad shape
    for the whole sequence (``scripts/reference_oracle.py:918-932``)."""
    u_max = e_max = 0
    for nodes in batches:
        uniq = set().union(*_union_sets(indptr, indices, nodes),
                           map(int, nodes))
        exp = set().union(*_union_sets(indptr, indices, sorted(uniq)))
        u_max, e_max = max(u_max, len(uniq)), max(e_max, len(exp))
    return (-(-u_max // multiple) * multiple,
            -(-e_max // multiple) * multiple)


def init_exact_params(feat_dim: int, emb_dim: int = 64, *,
                      generator: Optional[torch.Generator] = None,
                      device: DeviceLike = None) -> dict:
    """Xavier-uniform ``[out, in]`` weights like the reference
    (``src/graphsage.py:168,388-390``), leaves that take gradients."""
    device = resolve_device(device)
    out = {}
    for name, shape in (("w_enc", (emb_dim, feat_dim)),
                        ("fc", (emb_dim, emb_dim)),
                        ("w_score", (1, emb_dim))):
        bound = math.sqrt(6.0 / sum(shape))
        w = torch.empty(shape).uniform_(-bound, bound, generator=generator)
        out[name] = w.to(device).requires_grad_()
    return out


def _sym_norm(mask: torch.Tensor) -> torch.Tensor:
    r = mask.sum(1, keepdim=True)
    c = mask.sum(0, keepdim=True)
    ri = torch.where(r > 0, torch.rsqrt(r.clamp(min=1e-30)), 0.0)
    ci = torch.where(c > 0, torch.rsqrt(c.clamp(min=1e-30)), 0.0)
    return mask * ri * ci


def exact_forward(params: dict, feats: torch.Tensor, b: ExactBatch):
    """``GCNEncoder.forward`` + ``GCN.forward``, the train path.

    Returns (scores [B], combined_all [B, D] in reordered order, context
    [B, D] in batch order, rec_terms [B] zero off the anomaly slots, the
    anomaly-slot mask [B])."""
    to_feats = _sym_norm(b.mask1) @ feats[b.uniq]             # [B, F]
    r1 = b.mask1.sum(1, keepdim=True)
    mask_row = b.mask1 * torch.where(r1 > 0, 1.0 / r1.clamp(min=1e-30),
                                     0.0)
    nf_expand = _sym_norm(b.mask2) @ feats[b.expand]          # [U, F]

    combined = torch.relu(to_feats @ params["w_enc"].T)       # [B, D]
    combined_expand = torch.relu(nf_expand @ params["w_enc"].T)
    context = mask_row @ combined_expand                      # [B, D]

    cp = combined[b.perm]
    gen = torch.relu(context[b.perm] @ params["fc"].T)       # [B, D]
    am = b.labels[b.perm] == 1
    combined_all = torch.where(am[:, None], gen, cp)

    scores = (combined_all @ params["w_score"].T)[:, 0]
    # recon2: per anomaly, sqrt of the FEATURE-axis sum
    rec_rows = (cp - gen).square().sum(1).clamp(min=1e-30).sqrt()
    rec_terms = torch.where(am, rec_rows, 0.0)
    return scores, combined_all, context, rec_terms, am


def exact_losses(params: dict, feats: torch.Tensor, b: ExactBatch):
    """total, (cls, constraint, rec): ``GCN.loss``
    (``src/graphsage.py:244-258``), quirks kept."""
    scores, combined_all, context, rec_terms, am = exact_forward(
        params, feats, b)
    y = b.labels
    # BCE with logits against labels in BATCH order, scores reordered
    loss_cls = ((1 - y) * torch.nn.functional.softplus(scores)
                + y * torch.nn.functional.softplus(-scores)).mean()
    # cos(combined_all[i], context[i]), the context in batch order
    num = (combined_all * context).sum(1)
    den = combined_all.norm(dim=1) * context.norm(dim=1)
    aff = num / den.clamp(min=1e-8)
    n_norm = (1 - y).sum()
    n_anom = y.sum().clamp(min=1.0)
    aff_norm = torch.where(y == 0, aff, 0.0).sum() / n_norm.clamp(min=1.0)
    aff_anom = torch.where(y == 1, aff, 0.0).sum() / n_anom
    loss_constraint = torch.clamp(1.0 - (aff_norm - aff_anom), min=0.0)
    loss_rec = rec_terms.sum() / am.sum().clamp(min=1).float()
    total = loss_cls + loss_constraint + 0.1 * loss_rec
    return total, (loss_cls, loss_constraint, loss_rec)


def exact_scores(params: dict, feats: torch.Tensor,
                 b: ExactBatch) -> torch.Tensor:
    """Eval-path probabilities (``GCN.to_prob``): sigmoid(w·combined), no
    reordering."""
    to_feats = _sym_norm(b.mask1) @ feats[b.uniq]
    combined = torch.relu(to_feats @ params["w_enc"].T)
    return torch.sigmoid((combined @ params["w_score"].T)[:, 0])


@torch.no_grad()
def exact_score_nodes(params: dict, feats: torch.Tensor, indptr, indices,
                      ids: np.ndarray, slice_size: int = 150
                      ) -> np.ndarray:
    """:func:`exact_scores` of ``ids`` in slices of ``slice_size`` (the
    column normalization depends on how a slice is made up), the 1-hop
    pad the largest union rounded up to 32
    (``scripts/reference_oracle.py:945-977``); on the host."""
    ids = np.asarray(ids, np.int64)
    slices = [ids[i: i + slice_size] for i in range(0, len(ids), slice_size)]
    u_max = max(len(set().union(*_union_sets(indptr, indices, s),
                                map(int, s))) for s in slices)
    u_ev = -(-u_max // 32) * 32
    out = [exact_scores(params, feats, build_exact_batch(
        indptr, indices, s, np.zeros(len(s), np.float32), u_ev, 32,
        two_hop=False, device=feats.device)) for s in slices]
    return torch.cat(out).cpu().numpy()
