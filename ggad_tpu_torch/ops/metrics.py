"""Evaluation metrics: AUROC and average precision, host-side numpy copies
of ``ggad_tpu/ops/metrics.py:21-69`` (sklearn parity); the minibatch
path's thresholded metrics (F1 trio, confusion, G-mean), copies of
``metrics.py:71-111``; and :func:`roc_auc_torch`, the on-device AUROC of
``roc_auc_jnp``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def prob_to_pred(probs: np.ndarray, thres: float) -> np.ndarray:
    """Threshold probabilities (reference ``src/utils.py:250-260``)."""
    return (np.asarray(probs) >= thres).astype(np.int64)


def f1_scores(labels: np.ndarray, preds: np.ndarray
              ) -> tuple[float, float, float]:
    """(f1_macro, f1_binary_pos, f1_binary_neg), the reference's trio
    (``src/utils.py:238-247``)."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()

    def f1_for(cls):
        tp = np.sum((preds == cls) & (labels == cls))
        fp = np.sum((preds == cls) & (labels != cls))
        fn = np.sum((preds != cls) & (labels == cls))
        denom = 2 * tp + fp + fn
        return 2 * tp / denom if denom > 0 else 0.0

    f1_pos, f1_neg = f1_for(1), f1_for(0)
    return (f1_pos + f1_neg) / 2.0, f1_pos, f1_neg


def confusion(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """2x2 confusion matrix [[tn, fp], [fn, tp]] (sklearn layout)."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    tn = np.sum((labels == 0) & (preds == 0))
    fp = np.sum((labels == 0) & (preds == 1))
    fn = np.sum((labels == 1) & (preds == 0))
    tp = np.sum((labels == 1) & (preds == 1))
    return np.array([[tn, fp], [fn, tp]])


def gmean_from_confusion(conf: np.ndarray) -> float:
    """G-mean = sqrt(sensitivity · specificity)
    (reference ``src/utils.py:324-326``)."""
    tn, fp = conf[0]
    fn, tp = conf[1]
    sens = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    spec = tn / (tn + fp) if (tn + fp) > 0 else 0.0
    return float(np.sqrt(sens * spec))


def roc_auc_torch(labels: torch.Tensor, scores: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AUROC on the scores' device, the counterpart of ``roc_auc_jnp``
    (``ggad_tpu/ops/metrics.py:118-162``): ``mask`` selects the evaluated
    subset; masked-out entries sort below every kept one; ties take
    midranks through a stable argsort. f32 throughout, as JAX computes it.
    Returns a 0-d tensor."""
    labels = labels.float()
    mask = torch.ones_like(labels) if mask is None else mask.float()
    s = torch.where(mask > 0, scores.float(),
                    torch.full_like(scores, torch.finfo(torch.float32).min,
                                    dtype=torch.float32))
    n = labels.shape[0]
    order = torch.argsort(s, stable=True)
    sorted_s = s[order]
    new_run = torch.ones(n, dtype=torch.int64, device=s.device)
    new_run[1:] = (sorted_s[1:] != sorted_s[:-1]).long()
    run_id = torch.cumsum(new_run, 0) - 1
    pos1 = torch.arange(1, n + 1, dtype=torch.float32, device=s.device)
    run_sum = torch.zeros(n, device=s.device).index_add_(0, run_id, pos1)
    run_cnt = torch.zeros(n, device=s.device).index_add_(
        0, run_id, torch.ones(n, device=s.device))
    mid = run_sum / run_cnt.clamp(min=1.0)
    ranks = torch.zeros(n, device=s.device).index_copy_(0, order,
                                                        mid[run_id])
    pos = labels * mask
    neg = (1.0 - labels) * mask
    n_pos, n_neg = pos.sum(), neg.sum()
    # masked-out entries rank below every kept one: remove that shift
    rank_sum_pos = (ranks * pos).sum() - n_pos * (1.0 - mask).sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg).clamp(min=1.0)
