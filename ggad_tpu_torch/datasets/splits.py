"""Train/val/test splitting with the reference's exact semantics
(counterpart of ``ggad_tpu/datasets/splits.py``; same seed, same arrays).

Reference ``utils.py:89-141``:
  * shuffle all node ids; 30% train / 10% val / 60% test;
  * labeled normals = first ``rate`` (default 0.5) of the normal nodes in
    the train split;
  * shuffle labeled normals; the outlier-seed set ("abnormal_label_idx") is
    the first ``seed_frac`` of them (0.05 for Amazon, 0.15 otherwise).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SplitResult:
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    normal_label_idx: np.ndarray
    abnormal_label_idx: np.ndarray


def reference_split(
    ano_labels: np.ndarray,
    *,
    seed: int = 0,
    train_rate: float = 0.3,
    val_rate: float = 0.1,
    labeled_normal_rate: float = 0.5,
    seed_frac: float = 0.15,
) -> SplitResult:
    """Reproduce the reference split semantics with a seeded RNG. The
    JAX package's contamination options (the reference's commented
    robustness experiments) are not carried: no loader uses them."""
    rng = np.random.default_rng(seed)
    n = int(ano_labels.shape[0])
    all_idx = rng.permutation(n)
    n_train = int(n * train_rate)
    n_val = int(n * val_rate)
    idx_train = all_idx[:n_train]
    idx_val = all_idx[n_train:n_train + n_val]
    idx_test = all_idx[n_train + n_val:]

    normals_in_train = idx_train[ano_labels[idx_train] == 0]
    n_labeled = int(len(normals_in_train) * labeled_normal_rate)
    normal_label_idx = normals_in_train[:n_labeled].copy()

    rng.shuffle(normal_label_idx)
    n_seed = int(len(normal_label_idx) * seed_frac)
    abnormal_label_idx = normal_label_idx[:n_seed].copy()

    return SplitResult(
        idx_train=np.sort(idx_train),
        idx_val=np.sort(idx_val),
        idx_test=np.sort(idx_test),
        normal_label_idx=normal_label_idx,
        abnormal_label_idx=abnormal_label_idx,
    )
