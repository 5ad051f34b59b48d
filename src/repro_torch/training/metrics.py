"""CTR evaluation metrics — AUC (rank statistic) and LogLoss (paper Table I).

Counterpart of ``repro.training.metrics``: the same numpy code, so the
two packages score the same arrays identically.
"""

from __future__ import annotations

import numpy as np

__all__ = ["roc_auc", "logloss"]


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney U formulation; ties get average ranks."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i:j + 1]] = avg
        r += j - i + 1
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def logloss(labels: np.ndarray, probs: np.ndarray,
            eps: float = 1e-7) -> float:
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    probs = np.clip(np.asarray(probs, dtype=np.float64).reshape(-1),
                    eps, 1 - eps)
    return float(-np.mean(labels * np.log(probs)
                          + (1 - labels) * np.log(1 - probs)))
