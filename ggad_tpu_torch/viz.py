"""Diagnostics and figures (counterpart of ``ggad_tpu/viz.py``; reference
``utils.py:175-263``, ``utils_tam.py:92-139,249-308``).

Affinity histograms with fitted normal curves, ROC and PR curves. Each
function takes numpy arrays or tensors (a tensor is read through
``.detach().cpu()``) and imports matplotlib when it is called: matplotlib
is a host-side extra that the card's machine need not have, and nothing
else of the port imports it.
"""

from __future__ import annotations

import os

import numpy as np

_COLORS = ("steelblue", "darkorange", "green")


def _host(x) -> np.ndarray:
    """A flat numpy array of ``x`` (array, list or tensor)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).ravel()


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _normpdf(bins: np.ndarray, mu: float, sigma: float) -> np.ndarray:
    sigma = max(float(sigma), 1e-12)
    return (1.0 / (sigma * np.sqrt(2 * np.pi))
            * np.exp(-0.5 * ((bins - mu) / sigma) ** 2))


def _affinity_panel(ax, pops, bins: int, labels) -> None:
    """One panel: the three populations' histograms and fitted normals."""
    groups = [_host(m) for m in pops]
    _, bin_edges, _ = ax.hist(groups, bins=bins, density=True, label=labels)
    for g, c in zip(groups, _COLORS):
        if len(g) > 1:
            ax.plot(bin_edges, _normpdf(bin_edges, g.mean(), g.std()),
                    color=c, linestyle="--", linewidth=3.0)
    ax.set_xlabel("Local affinity")


def draw_affinity_pdf(message_normal, message_outlier, message_real_abnormal,
                      out_path: str, *, bins: int = 30,
                      labels=("Normal", "Outlier", "Abnormal")) -> str:
    """Histogram of the three affinity populations with fitted Gaussians
    (reference ``draw_pdf``, ``utils.py:186-224``)."""
    plt = _pyplot()
    _ensure_dir(out_path)
    fig, ax = plt.subplots(figsize=(8.5, 7.5))
    _affinity_panel(ax, (message_normal, message_outlier,
                         message_real_abnormal), bins, labels)
    ax.legend(loc="upper left")
    ax.set_ylabel("Density")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def draw_affinity_pdf_methods(methods, out_path: str, *, bins: int = 30,
                              labels=("Normal", "Outlier",
                                      "Abnormal")) -> str:
    """Per-method affinity histograms as aligned panels of one figure
    (reference ``draw_pdf_methods``, ``utils.py:227-263``, which writes a
    file a method). ``methods``: ``name -> (message_normal,
    message_outlier, message_real_abnormal)``."""
    plt = _pyplot()
    _ensure_dir(out_path)
    n = max(len(methods), 1)
    fig, axes = plt.subplots(1, n, figsize=(6.0 * n, 5.5), squeeze=False)
    for ax, (name, pops) in zip(axes[0], methods.items()):
        _affinity_panel(ax, pops, bins, labels)
        ax.set_title(name)
    axes[0][0].set_ylabel("Density")
    axes[0][0].legend(loc="upper left")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def roc_curve(labels, scores) -> tuple[np.ndarray, np.ndarray]:
    """(FPR, TPR) over the scores in descending order, from (0, 0)."""
    labels, scores = _host(labels), _host(scores)
    l_sorted = labels[np.argsort(-scores)]
    tpr = np.concatenate([[0], np.cumsum(l_sorted) / max(l_sorted.sum(), 1)])
    fpr = np.concatenate([[0], np.cumsum(1 - l_sorted)
                          / max((1 - l_sorted).sum(), 1)])
    return fpr, tpr


def pr_curve(labels, scores) -> tuple[np.ndarray, np.ndarray]:
    """(recall, precision) at each cut of the scores in descending order."""
    labels, scores = _host(labels), _host(scores)
    l_sorted = labels[np.argsort(-scores)]
    tp = np.cumsum(l_sorted)
    return (tp / max(l_sorted.sum(), 1),
            tp / np.arange(1, len(l_sorted) + 1))


def draw_roc(labels, scores, out_path: str) -> str:
    """ROC curve (reference ``draw_roc``, ``utils_tam.py:254-276``)."""
    plt = _pyplot()
    fpr, tpr = roc_curve(labels, scores)
    _ensure_dir(out_path)
    fig, ax = plt.subplots()
    ax.plot(fpr, tpr)
    ax.plot([0, 1], [0, 1], "k--", linewidth=0.8)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def draw_pr(labels, scores, out_path: str) -> str:
    """Precision-recall curve (reference ``draw_pr``,
    ``utils_tam.py:279-301``)."""
    plt = _pyplot()
    recall, precision = pr_curve(labels, scores)
    _ensure_dir(out_path)
    fig, ax = plt.subplots()
    ax.plot(recall, precision)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
