"""Graph reordering for tile locality (counterpart of
``ggad_tpu/datasets/reorder.py``; host-side numpy/scipy, the same code).

Reverse Cuthill-McKee renumbers nodes so neighbours get nearby ids,
concentrating edges near the diagonal. That raises the edges per occupied
128×128 tile, so it decides whether a graph takes the BCSR tiles or the ELL
tables under ``spmm_impl="auto"``. Scores and labels are permuted
consistently, so results are identical up to node renumbering.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ggad_tpu_torch.datasets.core import GADDataset


def rcm_permutation(adj: sp.csr_matrix) -> np.ndarray:
    """perm[i] = old id at new position i."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(adj.tocsr(), symmetric_mode=True))


def apply_permutation(ds: GADDataset, perm: np.ndarray) -> GADDataset:
    """Renumber the dataset by ``perm`` (new -> old)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))

    adj = ds.adj[perm][:, perm].tocsr()
    return dataclasses.replace(
        ds,
        adj=adj,
        features=ds.features[perm],
        ano_labels=ds.ano_labels[perm],
        idx_train=np.sort(inv[ds.idx_train]),
        idx_val=np.sort(inv[ds.idx_val]),
        idx_test=np.sort(inv[ds.idx_test]),
        normal_label_idx=inv[ds.normal_label_idx],
        abnormal_label_idx=inv[ds.abnormal_label_idx],
        str_ano_labels=(ds.str_ano_labels[perm]
                        if ds.str_ano_labels is not None else None),
        attr_ano_labels=(ds.attr_ano_labels[perm]
                         if ds.attr_ano_labels is not None else None),
    )


def reorder_rcm(ds: GADDataset) -> GADDataset:
    return apply_permutation(ds, rcm_permutation(ds.adj))


def tile_occupancy(adj: sp.csr_matrix, tile: int = 128) -> tuple[int, float]:
    """(occupied_tiles, edges_per_occupied_tile) for a CSR adjacency."""
    coo = adj.tocoo()
    n_pad_tiles = -(-adj.shape[0] // tile)
    keys = (coo.row // tile).astype(np.int64) * n_pad_tiles \
        + coo.col // tile
    occ = len(np.unique(keys))
    return occ, coo.nnz / max(occ, 1)
