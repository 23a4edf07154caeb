"""Dataset loaders: reference-format ``.mat`` / DGraph ``.npz`` / synthetic
(counterpart of ``ggad_tpu/datasets/loaders.py``).

  * ``load_mat`` reads the reference's MATLAB keys (``Network``/``A``,
    ``Attributes``/``X``, ``Label``/``gnd``, optional
    ``str_anomaly_label``/``attr_anomaly_label``) — reference
    ``utils.py:66-87``.
  * ``load_dgraphfin`` reads ``dgraphfin.npz`` (``x``, ``y``,
    ``edge_index``) — reference ``src/utils.py:15-61``;
    ``load_dgraphfin_dataset`` wraps it as a :class:`GADDataset`.
  * When a file is absent, ``load_dataset`` falls back to a shape-matched
    synthetic graph and says so with a ``[synthetic fallback]`` line.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.sparse as sp

from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.datasets.registry import preset_for
from ggad_tpu_torch.datasets.splits import reference_split
from ggad_tpu_torch.datasets.synthetic import (
    SYNTH_SHAPES,
    synthetic_gad,
    synthetic_like,
)
from ggad_tpu_torch.ops.normalize import row_normalize_features

DATA_DIR = os.environ.get("GGAD_TPU_DATA_DIR", "./dataset")


def load_mat(dataset: str, *, data_dir: str = None, seed: int = 0) -> GADDataset:
    """Load a reference-format ``.mat`` GAD benchmark."""
    import scipy.io as sio

    data_dir = data_dir or DATA_DIR
    data = sio.loadmat(os.path.join(data_dir, f"{dataset}.mat"))
    label = data["Label"] if "Label" in data else data["gnd"]
    attr = data["Attributes"] if "Attributes" in data else data["X"]
    network = data["Network"] if "Network" in data else data["A"]

    adj = sp.csr_matrix(network)
    feat = sp.lil_matrix(attr)
    ano_labels = np.squeeze(np.asarray(label))
    str_ano = (np.squeeze(np.asarray(data["str_anomaly_label"]))
               if "str_anomaly_label" in data else None)
    attr_ano = (np.squeeze(np.asarray(data["attr_anomaly_label"]))
                if "attr_anomaly_label" in data else None)

    preset = preset_for(dataset)
    if preset.row_normalize:
        features = row_normalize_features(np.asarray(feat.todense()))
    else:
        features = np.asarray(feat.todense(), dtype=np.float32)

    split = reference_split(ano_labels, seed=seed,
                            seed_frac=preset.seed_frac)
    return GADDataset(
        name=dataset,
        adj=adj,
        features=features,
        ano_labels=ano_labels,
        idx_train=split.idx_train,
        idx_val=split.idx_val,
        idx_test=split.idx_test,
        normal_label_idx=split.normal_label_idx,
        abnormal_label_idx=split.abnormal_label_idx,
        str_ano_labels=str_ano,
        attr_ano_labels=attr_ano,
    )


def load_dgraphfin(*, data_dir: str = None
                   ) -> tuple[sp.csr_matrix, np.ndarray, np.ndarray]:
    """Load DGraph-Fin: (adjacency CSR with self-loops, features, labels).

    Reference ``src/utils.py:15-61``: features from ``x``; labels =
    (y == 1); the edge list is symmetrized and self-loops are added.
    """
    data_dir = data_dir or DATA_DIR
    data = np.load(os.path.join(data_dir, "dgraphfin.npz"))
    feats = np.asarray(data["x"], dtype=np.float32)
    labels = (np.asarray(data["y"]).ravel() == 1).astype(np.int64)
    ei = np.asarray(data["edge_index"])
    if ei.shape[0] != 2:
        ei = ei.T
    n = feats.shape[0]
    adj = sp.coo_matrix(
        (np.ones(ei.shape[1], dtype=np.float32), (ei[0], ei[1])),
        shape=(n, n)).tocsr()
    adj = adj.maximum(adj.T)
    adj = adj + sp.eye(n, dtype=np.float32, format="csr")
    adj.data[:] = 1.0
    return adj, feats, labels


def load_dgraphfin_dataset(*, data_dir: str = None,
                           seed: int = 0) -> GADDataset:
    """DGraph-Fin as a :class:`GADDataset`. ``adj`` holds A without
    self-loops (every consumer adds them itself: the full-batch path via
    ``normalize_adj_reference``, the minibatch path via ``adj + I``), so
    :func:`load_dgraphfin`'s self-loops are stripped here."""
    adj, feats, labels = load_dgraphfin(data_dir=data_dir)
    adj = adj.tolil()
    adj.setdiag(0)
    adj = adj.tocsr()
    adj.eliminate_zeros()
    split = reference_split(labels, seed=seed,
                            seed_frac=preset_for("dgraphfin").seed_frac)
    return GADDataset(
        name="dgraphfin",
        adj=adj,
        features=feats,
        ano_labels=labels,
        idx_train=split.idx_train,
        idx_val=split.idx_val,
        idx_test=split.idx_test,
        normal_label_idx=split.normal_label_idx,
        abnormal_label_idx=split.abnormal_label_idx,
    )


def load_dataset(name: str, *, data_dir: str = None, seed: int = 0,
                 synthetic_scale: float = 1.0,
                 allow_synthetic: bool = True) -> GADDataset:
    """Load ``name`` from disk, or fall back to a shape-matched synthetic.

    Real-data routes (in order): ``{name}.mat``, then ``dgraphfin.npz``
    for ``name='dgraphfin'``. A named benchmark with no file on disk falls
    back to a synthetic graph only when ``allow_synthetic`` (the default),
    and prints a ``[synthetic fallback]`` marker; otherwise it raises.
    """
    data_dir = data_dir or DATA_DIR
    if os.path.exists(os.path.join(data_dir, f"{name}.mat")):
        return load_mat(name, data_dir=data_dir, seed=seed)
    if name == "dgraphfin" and os.path.exists(
            os.path.join(data_dir, "dgraphfin.npz")):
        return load_dgraphfin_dataset(data_dir=data_dir, seed=seed)
    if name.startswith("synthetic"):
        return synthetic_gad(name, seed=seed, split_seed=seed)
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no real data for {name!r} in {data_dir!r} "
            f"(looked for {name}.mat"
            + (" and dgraphfin.npz" if name == "dgraphfin" else "")
            + ") and allow_synthetic=False")
    print(f"[synthetic fallback] no real data for {name!r} in "
          f"{data_dir!r} — training on a SYNTHETIC graph; metrics are "
          f"NOT comparable to published {name} results",
          file=sys.stderr, flush=True)
    if name in SYNTH_SHAPES:
        return synthetic_like(name, scale=synthetic_scale, seed=seed)
    return synthetic_gad(name, seed=seed, split_seed=seed)
