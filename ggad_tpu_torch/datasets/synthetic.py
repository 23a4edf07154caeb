"""Synthetic GAD benchmark generator (counterpart of
``ggad_tpu/datasets/synthetic.py``; the same seed gives bit-identical arrays).

Community-structured normal nodes with Gaussian features, plus two planted
anomaly types: structural cliques and attribute outliers. From 200,000
nodes the graph is symmetrized and compressed in the host library
(``native.symmetrize`` + ``build_indptr``, as the JAX package does), which
builds the same matrix as scipy's ``maximum(adj.T)`` below that.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ggad_tpu_torch import native
from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.datasets.splits import reference_split

# (n_nodes, n_edges, feat_dim) of the reference benchmarks (README.md:51-58)
SYNTH_SHAPES = {
    "photo": (7_535, 119_043, 745),
    "reddit": (10_984, 168_016, 64),
    "Amazon": (11_944, 4_398_392, 25),
    "t_finance": (39_357, 21_222_543, 10),
    "elliptic": (46_564, 73_248, 93),
    "dgraphfin": (3_700_550, 73_105_508, 17),
}


def synthetic_gad(
    name: str = "synthetic",
    *,
    n_nodes: int = 2000,
    avg_degree: int = 16,
    feat_dim: int = 64,
    n_communities: int = 8,
    anomaly_rate: float = 0.05,
    feature_noise: float = 0.4,
    intra_frac: float = 0.9,
    n_relations: int = 0,
    seed: int = 0,
    split_seed: int = 0,
    seed_frac: float = 0.15,
) -> GADDataset:
    """Generate a seeded synthetic GAD dataset.

    Normal nodes: community-clustered features + mostly intra-community
    edges. Anomalies: half structural (dense random cliques across
    communities), half attribute (features from a far-off distribution).
    """
    rng = np.random.default_rng(seed)
    n_anom = int(n_nodes * anomaly_rate)
    labels = np.zeros(n_nodes, dtype=np.int64)
    anom_idx = rng.choice(n_nodes, size=n_anom, replace=False)
    labels[anom_idx] = 1

    comm = rng.integers(0, n_communities, size=n_nodes)
    centers = rng.normal(0.0, 1.0, size=(n_communities, feat_dim))
    feats = centers[comm] + rng.normal(0.0, feature_noise,
                                       size=(n_nodes, feat_dim))

    # attribute anomalies: features far from every community center
    attr_anom = anom_idx[: n_anom // 2]
    feats[attr_anom] = rng.normal(0.0, 1.0, size=(len(attr_anom), feat_dim)) * 3.0

    # --- edges -----------------------------------------------------------
    m = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, size=2 * m)
    dst = np.empty_like(src)
    # intra-community partner for intra_frac of edges, random otherwise
    same = rng.random(2 * m) < intra_frac
    for c in range(n_communities):
        members = np.flatnonzero(comm == c)
        sel = same & (comm[src] == c)
        dst[sel] = members[rng.integers(0, len(members), size=sel.sum())]
    rand_sel = ~same
    dst[rand_sel] = rng.integers(0, n_nodes, size=rand_sel.sum())

    # structural anomalies: cliques of random cross-community nodes
    struct_anom = anom_idx[n_anom // 2:]
    clique_size = 8
    extra_src, extra_dst = [], []
    for start in range(0, len(struct_anom), clique_size):
        grp = struct_anom[start:start + clique_size]
        if len(grp) < 2:
            continue
        a, b = np.meshgrid(grp, grp)
        mask = a != b
        extra_src.append(a[mask])
        extra_dst.append(b[mask])
    if extra_src:
        src = np.concatenate([src, *extra_src])
        dst = np.concatenate([dst, *extra_dst])

    keep = src != dst
    src, dst = src[keep], dst[keep]
    if n_nodes >= 200_000 and native.available():
        # scipy's maximum(adj.T) is the host build's cost at DGraph scale
        rows, cols, vals = native.symmetrize(src, dst, None)
        adj = sp.csr_matrix((vals, cols, native.build_indptr(rows, n_nodes)),
                            shape=(n_nodes, n_nodes))
    else:
        adj = sp.coo_matrix(
            (np.ones(len(src), dtype=np.float32), (src, dst)),
            shape=(n_nodes, n_nodes))
        adj = adj.maximum(adj.T)   # symmetrize
    adj.data[:] = 1.0              # binary, like the reference graphs
    adj = adj.tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()

    split = reference_split(labels, seed=split_seed, seed_frac=seed_frac)
    relations = None
    if n_relations > 0:
        relations = split_relations(adj, n_relations, seed=seed)
    return GADDataset(
        name=name,
        adj=adj,
        features=feats.astype(np.float32),
        ano_labels=labels,
        idx_train=split.idx_train,
        idx_val=split.idx_val,
        idx_test=split.idx_test,
        normal_label_idx=split.normal_label_idx,
        abnormal_label_idx=split.abnormal_label_idx,
        relations=relations,
    )


def split_relations(adj: sp.csr_matrix, n_relations: int,
                    seed: int = 0) -> list:
    """Partition an adjacency's edges into ``n_relations`` symmetric
    relation graphs (the shape of yelp's RUR/RTR/RSR; PC-GNN takes one
    neighbor table a relation). Each undirected edge draws its relation
    from ``default_rng(seed + 12345)``."""
    rng = np.random.default_rng(seed + 12345)
    coo = sp.triu(adj, k=1).tocoo()     # undirected edges once
    rel = rng.integers(0, n_relations, size=coo.nnz)
    out = []
    for r in range(n_relations):
        m = rel == r
        a = sp.coo_matrix(
            (np.ones(int(m.sum()), np.float32),
             (coo.row[m], coo.col[m])), shape=adj.shape)
        out.append((a + a.T).tocsr())
    return out


def synthetic_like(name: str, *, scale: float = 1.0, seed: int = 0,
                   seed_frac: float | None = None) -> GADDataset:
    """A synthetic dataset with the shape profile of a reference benchmark.

    The published edge counts are adjacency nnz; ``synthetic_gad`` draws
    n·avg_degree directed pairs and symmetrizes (nnz ≈ 2·n·avg_degree), so
    avg_degree = e/(2n) reproduces the published nnz.
    """
    n, e, f = SYNTH_SHAPES[name]
    n = max(int(n * scale), 256)
    e = max(int(e * scale), 1024)
    avg_degree = max(e // (2 * n), 2)
    if seed_frac is None:
        seed_frac = 0.05 if name == "Amazon" else 0.15
    return synthetic_gad(
        name=f"synthetic_{name}",
        n_nodes=n,
        avg_degree=avg_degree,
        feat_dim=f,
        seed=seed,
        seed_frac=seed_frac,
    )


def photo_bench(seed: int = 0) -> GADDataset:
    """The photo-shaped serving graph of the repo's benchmark
    (``bench.py:45-49``): 7,535 nodes, ~456K edges, 745 features."""
    return synthetic_gad(
        name="bench_photo", n_nodes=7535, avg_degree=31, feat_dim=745,
        n_communities=8, anomaly_rate=0.09, seed=seed, seed_frac=0.15)
