"""The benchmark's graphs: a copy of the port's synthetic generator
(``ggad_tpu_torch/datasets/synthetic.py``: ``synthetic_gad`` and
``synthetic_like``) and of its two splits (``datasets/splits.py``:
``reference_split`` and ``tam_split``), so that the inputs do not move when
the program's copy does.

A configuration names the published shape (nodes, adjacency entries,
features) and a fixed data seed; the graph is the same for every run seed,
as a dataset file would be. The generated host arrays are kept in
``portbench/cache/`` (git-ignored) under a name hashed from the shape and
this file, so only the first run in a checkout pays the generator.

Only the scipy route of the generator is copied: the program takes its
host library (``native.symmetrize``) from 200,000 nodes, and every
configuration here is below that, where both build the same matrix.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import scipy.sparse as sp

CACHE_DIR = Path(__file__).resolve().parent / "cache"


@dataclasses.dataclass
class Graph:
    """Host arrays of one generated dataset and its split."""

    adj: sp.csr_matrix          # binary, symmetric, zero diagonal
    features: np.ndarray        # [N, F] float32
    labels: np.ndarray          # [N] int64, 1 = anomaly
    normal_idx: np.ndarray      # labeled normal nodes
    seed_idx: np.ndarray        # GGAD's outlier seeds (empty for TAM)

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[0]


def synthetic_gad(*, n_nodes: int, avg_degree: int, feat_dim: int,
                  n_communities: int = 8, anomaly_rate: float = 0.05,
                  feature_noise: float = 0.4, intra_frac: float = 0.9,
                  seed: int = 0):
    """(adj, features, labels): community-clustered normal nodes with
    Gaussian features, half the anomalies in cliques of 8 and half with
    far-off features (``synthetic.py:33-115``, scipy route)."""
    rng = np.random.default_rng(seed)
    n_anom = int(n_nodes * anomaly_rate)
    labels = np.zeros(n_nodes, dtype=np.int64)
    anom_idx = rng.choice(n_nodes, size=n_anom, replace=False)
    labels[anom_idx] = 1

    comm = rng.integers(0, n_communities, size=n_nodes)
    centers = rng.normal(0.0, 1.0, size=(n_communities, feat_dim))
    feats = centers[comm] + rng.normal(0.0, feature_noise,
                                       size=(n_nodes, feat_dim))
    attr_anom = anom_idx[: n_anom // 2]
    feats[attr_anom] = rng.normal(0.0, 1.0,
                                  size=(len(attr_anom), feat_dim)) * 3.0

    m = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, size=2 * m)
    dst = np.empty_like(src)
    same = rng.random(2 * m) < intra_frac
    for c in range(n_communities):
        members = np.flatnonzero(comm == c)
        sel = same & (comm[src] == c)
        dst[sel] = members[rng.integers(0, len(members), size=sel.sum())]
    rand_sel = ~same
    dst[rand_sel] = rng.integers(0, n_nodes, size=rand_sel.sum())

    struct_anom = anom_idx[n_anom // 2:]
    extra_src, extra_dst = [], []
    for start in range(0, len(struct_anom), 8):
        grp = struct_anom[start:start + 8]
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
    adj = sp.coo_matrix((np.ones(len(src), dtype=np.float32), (src, dst)),
                        shape=(n_nodes, n_nodes))
    adj = adj.maximum(adj.T)
    adj.data[:] = 1.0
    adj = adj.tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    adj.sort_indices()
    return adj, feats.astype(np.float32), labels


def reference_split(labels: np.ndarray, *, seed: int, seed_frac: float,
                    train_rate: float = 0.3, labeled_normal_rate: float = 0.5
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(labeled normals, outlier seeds) of GGAD's split
    (``splits.py:33-91``, no contamination)."""
    rng = np.random.default_rng(seed)
    n = int(labels.shape[0])
    all_idx = rng.permutation(n)
    idx_train = all_idx[:int(n * train_rate)]
    normals = idx_train[labels[idx_train] == 0]
    normal_idx = normals[:int(len(normals) * labeled_normal_rate)].copy()
    rng.shuffle(normal_idx)
    seed_idx = normal_idx[:int(len(normal_idx) * seed_frac)].copy()
    return normal_idx, seed_idx


def tam_split(labels: np.ndarray, *, seed: int, train_rate: float = 0.3,
              labeled_normal_rate: float = 0.8,
              contamination_rate: float = 0.15) -> np.ndarray:
    """TAM's labeled normals (``splits.py:100-140``): 80% of the train
    split's normals plus 15% of all real anomalies."""
    rng = np.random.default_rng(seed)
    n = int(labels.shape[0])
    all_idx = rng.permutation(n)
    idx_train = all_idx[:int(n * train_rate)]
    normals = idx_train[labels[idx_train] == 0]
    normal_idx = normals[:int(len(normals) * labeled_normal_rate)].copy()
    real_abnormal = np.flatnonzero(labels == 1)
    rng.shuffle(real_abnormal)
    add = real_abnormal[:int(contamination_rate * len(real_abnormal))]
    return np.concatenate([normal_idx, add])


def generator_args(cfg: dict) -> dict:
    """``synthetic_like``'s arguments for a configuration's published
    shape: avg_degree = entries // (2·nodes), so the symmetrised graph
    holds about the published entries (``synthetic.py:143-166``)."""
    g = cfg["graph"]
    n, e = int(g["n_nodes"]), int(g["n_entries"])
    return dict(n_nodes=n, avg_degree=max(e // (2 * n), 2),
                feat_dim=int(g["feat_dim"]), seed=int(g["data_seed"]))


def _build(cfg: dict) -> dict:
    adj, feats, labels = synthetic_gad(**generator_args(cfg))
    g = cfg["graph"]
    if g["split"] == "ggad":
        normal_idx, seed_idx = reference_split(
            labels, seed=int(g["data_seed"]), seed_frac=float(g["seed_frac"]))
    elif g["split"] == "tam":
        normal_idx = tam_split(labels, seed=int(g["data_seed"]))
        seed_idx = np.zeros(0, np.int64)
    else:
        raise ValueError(f"unknown split {g['split']!r}")
    return dict(indptr=adj.indptr.astype(np.int64),
                indices=adj.indices.astype(np.int32), features=feats,
                labels=labels, normal_idx=normal_idx.astype(np.int64),
                seed_idx=seed_idx.astype(np.int64))


def _cache_path(cfg: dict) -> Path:
    key = json.dumps(cfg["graph"], sort_keys=True).encode()
    digest = hashlib.sha256(key + Path(__file__).read_bytes()).hexdigest()
    return CACHE_DIR / f"{cfg['name']}_{digest[:16]}.npz"


def load(cfg: dict, *, cache: bool = True) -> Graph:
    """The configuration's graph, from the cache or generated (and then
    cached, through a temporary file renamed into place)."""
    path = _cache_path(cfg)
    if cache and path.exists():
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    else:
        arrays = _build(cfg)
        if cache:
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
            np.savez(tmp, **arrays)
            os.replace(tmp, path)
    n = arrays["features"].shape[0]
    indices = arrays["indices"]
    adj = sp.csr_matrix((np.ones(len(indices), np.float32), indices,
                         arrays["indptr"]), shape=(n, n))
    return Graph(adj=adj, features=arrays["features"],
                 labels=arrays["labels"], normal_idx=arrays["normal_idx"],
                 seed_idx=arrays["seed_idx"])
