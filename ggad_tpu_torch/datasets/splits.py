"""Train/val/test splitting with the reference's exact semantics
(counterpart of ``ggad_tpu/datasets/splits.py``; same seed, same arrays).

Reference ``utils.py:89-141``:
  * shuffle all node ids; 30% train / 10% val / 60% test;
  * labeled normals = first ``rate`` (default 0.5) of the normal nodes in
    the train split;
  * shuffle labeled normals; the outlier-seed set ("abnormal_label_idx") is
    the first ``seed_frac`` of them (0.05 for Amazon, 0.15 otherwise).

``reference_split``'s contamination options and ``camouflage_features``
copy ``splits.py:40-97``; TAM's own protocol, ``tam_split``, copies
``splits.py:100-140``; the minibatch (DGraph) path's split,
``minibatch_split`` and its per-dataset presets, copies
``splits.py:143-262``.
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
    contamination_add_rate: float = 0.0,
    contamination_remove_rate: float = 0.0,
) -> SplitResult:
    """Reproduce the reference split semantics with a seeded RNG.

    ``contamination_add_rate``: fraction of real anomalies injected into
    the labeled-normal set (and, with ``contamination_remove_rate``,
    removed from the test split) — the reference's commented robustness
    experiments (``utils.py:111-127``) as options.
    """
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

    if contamination_add_rate > 0:
        real_abnormal = all_idx[ano_labels[all_idx] == 1].copy()
        rng.shuffle(real_abnormal)
        add = real_abnormal[: int(contamination_add_rate
                                  * len(real_abnormal))]
        remove_rate = contamination_remove_rate or contamination_add_rate
        remove = real_abnormal[: int(remove_rate * len(real_abnormal))]
        normal_label_idx = np.concatenate([normal_label_idx, add])
        idx_test = np.setdiff1d(idx_test, remove)

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


def camouflage_features(features: np.ndarray, ano_labels: np.ndarray,
                        normal_label_idx: np.ndarray,
                        replace_rate: float = 0.05) -> np.ndarray:
    """Camouflage robustness variant (reference ``utils.py:129-133``):
    overwrite the first ``replace_rate`` fraction of feature columns of
    every real anomaly with the labeled-normal mean."""
    feats = np.array(features, copy=True)
    normal_mean = feats[normal_label_idx].mean(axis=0)
    k = int(replace_rate * feats.shape[1])
    anom = np.flatnonzero(ano_labels == 1)
    feats[np.ix_(anom, np.arange(k))] = normal_mean[:k]
    return feats


def tam_split(ano_labels: np.ndarray, *, seed: int = 0,
              train_rate: float = 0.3, val_rate: float = 0.1,
              labeled_normal_rate: float = 0.8,
              contamination_rate: float = 0.15) -> SplitResult:
    """TAM's own split protocol (reference ``utils_tam.py:140-179``):

      * 30/10/60 train/val/test shuffle split;
      * labeled normals = first 80% of the normal nodes in train
        (vs. GGAD's 50%);
      * ACTIVE contamination: 15% of ALL real anomalies (shuffled) are
        appended to the labeled-normal set and removed from the test
        split.

    TAM has no outlier-seed set; ``abnormal_label_idx`` is empty.
    """
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

    real_abnormal = np.flatnonzero(ano_labels == 1)
    rng.shuffle(real_abnormal)
    add = real_abnormal[: int(contamination_rate * len(real_abnormal))]
    normal_label_idx = np.concatenate([normal_label_idx, add])
    idx_test = np.setdiff1d(idx_test, add)

    return SplitResult(
        idx_train=np.sort(idx_train),
        idx_val=np.sort(idx_val),
        idx_test=np.sort(idx_test),
        normal_label_idx=normal_label_idx,
        abnormal_label_idx=np.zeros(0, np.int64),
    )


def minibatch_split(
    ano_labels: np.ndarray,
    *,
    seed: int = 72,
    labeled_rate: float = 0.3,
    pseudo_anomaly_frac: float = 0.05,
    contamination_frac: float = 0.0,
    test_ratio: float = 0.6,
    seeds_in_train: bool = False,
    index_start: int = 0,
):
    """DGraph-style split (reference ``src/model_handler.py:150-178``).

      * 30% of normal nodes become labeled;
      * the first ``pseudo_anomaly_frac`` of those are *relabeled* as
        pseudo-anomalies (seeds);
      * optionally ``contamination_frac`` of real anomalies are moved into
        the train set (and removed from eval);
      * the rest is split valid/test stratified by label.

    ``seeds_in_train``: some reference branches keep the relabeled seeds
    inside ``idx_train``, others take the set difference.
    ``index_start``: amazon's nodes 0..3304 are unlabeled and excluded
    from every split (``src/model_handler.py:62``).

    Returns (idx_train, idx_valid, idx_test, labels_mutated, idx_anomaly).
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(ano_labels).copy()
    n = labels.shape[0]
    index = np.arange(index_start, n)
    idx_normal = index[labels[index] == 0]
    idx_real_abnormal = index[labels[index] == 1]

    rng.shuffle(idx_normal)
    idx_labeled = idx_normal[: int(len(idx_normal) * labeled_rate)]
    idx_anomaly = idx_labeled[: int(len(idx_labeled) * pseudo_anomaly_frac)]
    labels[idx_anomaly] = 1

    if seeds_in_train:
        idx_train = idx_labeled.copy()
    else:
        idx_train = np.setdiff1d(idx_labeled, idx_anomaly)
    contaminate = idx_real_abnormal[
        : int(len(idx_real_abnormal) * contamination_frac)]
    idx_train = np.concatenate([idx_train, contaminate])

    idx_rest = np.setdiff1d(index, idx_labeled)
    idx_rest = np.setdiff1d(idx_rest, contaminate)
    # stratified valid/test split
    rest_labels = labels[idx_rest]
    idx_valid_parts, idx_test_parts = [], []
    for cls in np.unique(rest_labels):
        cls_idx = idx_rest[rest_labels == cls]
        rng.shuffle(cls_idx)
        n_test = int(round(len(cls_idx) * test_ratio))
        idx_test_parts.append(cls_idx[:n_test])
        idx_valid_parts.append(cls_idx[n_test:])
    idx_valid = np.concatenate(idx_valid_parts)
    idx_test = np.concatenate(idx_test_parts)
    rng.shuffle(idx_valid)
    rng.shuffle(idx_test)

    return idx_train, idx_valid, idx_test, labels, idx_anomaly


# Per-dataset minibatch split presets, the reference's branches in
# ``src/model_handler.py:31-214``, one row each. All share labeled_rate
# 0.3; they differ in the seed fraction, whether seeds stay inside
# idx_train, contamination, and amazon's unlabeled-node offset.
MINIBATCH_SPLIT_PRESETS: dict = {
    "yelp": dict(pseudo_anomaly_frac=0.05, seeds_in_train=True),
    "amazon": dict(pseudo_anomaly_frac=0.05, seeds_in_train=False,
                   index_start=3305),
    "tsocial": dict(pseudo_anomaly_frac=0.1, seeds_in_train=True),
    "tfinance": dict(pseudo_anomaly_frac=0.1, seeds_in_train=True),
    "reddit": dict(pseudo_anomaly_frac=0.05, seeds_in_train=True),
    # 20% of real anomalies contaminate the train set
    "dgraphfin": dict(pseudo_anomaly_frac=0.05, seeds_in_train=False,
                      contamination_frac=0.2),
    "elliptic": dict(pseudo_anomaly_frac=0.05, seeds_in_train=False),
    "amazon_no_isolate": dict(pseudo_anomaly_frac=0.3,
                              seeds_in_train=True),
}

_SPLIT_NAME_ALIASES = {
    "t_finance": "tfinance",
    "tf_finace": "tfinance",      # the reference's typo'd key
    "tsocial_gad": "tsocial",
}


def minibatch_split_preset_name(dataset_name: str) -> str | None:
    """Map a dataset name (``synthetic_<name>`` fallbacks included) to its
    split preset, or None for the generic default."""
    name = dataset_name.lower()
    if name.startswith("synthetic_"):
        name = name[len("synthetic_"):]
    name = _SPLIT_NAME_ALIASES.get(name, name)
    return name if name in MINIBATCH_SPLIT_PRESETS else None


def minibatch_split_for(dataset_name: str, ano_labels: np.ndarray, *,
                        seed: int = 72, test_ratio: float = 0.6):
    """``minibatch_split`` with the dataset's reference preset applied
    (the generic defaults when the dataset has no reference branch)."""
    preset = minibatch_split_preset_name(dataset_name)
    kwargs = MINIBATCH_SPLIT_PRESETS.get(preset, {}) if preset else {}
    return minibatch_split(ano_labels, seed=seed, test_ratio=test_ratio,
                           **kwargs)
