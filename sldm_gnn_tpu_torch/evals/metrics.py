"""Evaluation metrics without sklearn.

Port of ``roc_auc_score`` from ``sldm_gnn_tpu/evals/metrics.py`` (:25);
the rest of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np


def roc_auc_score(gt: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based ROC-AUC with tie averaging (== sklearn.roc_auc_score);
    NaN when the ground truth has one class."""
    gt = np.asarray(gt).ravel()
    scores = np.asarray(scores).ravel().astype(np.float64)
    pos = gt == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(scores), np.float64)
    base = np.arange(1, len(scores) + 1, dtype=np.float64)
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        base[i:j + 1] = (i + 1 + j + 1) / 2.0
        i = j + 1
    ranks[order] = base
    rank_pos = ranks[pos].sum()
    return float((rank_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
