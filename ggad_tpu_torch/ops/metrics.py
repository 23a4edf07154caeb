"""Evaluation metrics: AUROC and average precision, host-side numpy copies
of ``ggad_tpu/ops/metrics.py:21-69`` (sklearn parity)."""

from __future__ import annotations

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """AUROC via the rank statistic (ties handled like sklearn)."""
    labels = np.asarray(labels).ravel().astype(np.float64)
    scores = np.asarray(scores).ravel().astype(np.float64)
    n_pos = labels.sum()
    n_neg = labels.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    # Average rank for ties == Mann-Whitney U with tie correction.
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.shape[0] + 1)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    rank_sum_pos = ranks[labels == 1].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """AP = Σ_k (R_k - R_{k-1}) P_k, sklearn-style (step interpolation)."""
    labels = np.asarray(labels).ravel().astype(np.float64)
    scores = np.asarray(scores).ravel().astype(np.float64)
    n_pos = labels.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    scores = scores[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    # collapse tied thresholds: only keep the last index of each distinct score
    distinct = np.where(np.diff(scores))[0]
    idx = np.concatenate([distinct, [labels.shape[0] - 1]])
    tp, fp = tp[idx], fp[idx]
    precision = tp / (tp + fp)
    recall = tp / n_pos
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))
