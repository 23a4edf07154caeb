"""Dataset container shared by all loaders (counterpart of
``ggad_tpu/datasets/core.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class GADDataset:
    """A graph anomaly-detection dataset in host memory.

    Mirrors the tuple returned by the reference's ``load_mat``
    (``utils.py:66-141``) as a structured object.
    """

    name: str
    adj: sp.csr_matrix            # raw adjacency A (no self-loops)
    features: np.ndarray          # [N, F] float32 (already normalized or raw)
    ano_labels: np.ndarray        # [N] {0,1} true anomaly labels
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    normal_label_idx: np.ndarray  # labeled normal nodes
    abnormal_label_idx: np.ndarray  # sacrificial outlier-seed nodes
    str_ano_labels: Optional[np.ndarray] = None
    attr_ano_labels: Optional[np.ndarray] = None
    relations: Optional[list] = None   # per-relation adjacencies (csr),
                                       # e.g. yelp's RUR/RTR/RSR, for
                                       # PC-GNN's multi-relation path

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def n_edges(self) -> int:
        return int(self.adj.nnz)

    @property
    def feat_dim(self) -> int:
        return int(self.features.shape[1])
