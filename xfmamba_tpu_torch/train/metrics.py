"""Host-side evaluation metrics (a copy of ``xfmamba_tpu/train/metrics.py``,
numpy only: the port imports nothing of the JAX package).

The reference's metric surface (``libs/training.py``): binary ROC-AUC from
softmax[:, 1] probabilities (:197-204), the per-label sigmoid mean AUC of
multi-label CheXpert (:205-214), and the confusion statistics written per
epoch (:24-59).  `roc_auc` is the rank-sum (Mann-Whitney U) statistic with
midranks for ties, equal to sklearn's ``roc_auc_score``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary AUROC via the rank-sum statistic (ties get midranks)."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    sorted_scores = scores[order]
    # midranks for tied groups
    i = 0
    r = np.empty(scores.size, dtype=np.float64)
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i:j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    ranks[order] = r
    auc = (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (
        n_pos * n_neg)
    return float(auc)


def multilabel_mean_auc(labels: np.ndarray, scores: np.ndarray,
                        return_per_label: bool = False):
    """Mean AUROC over label columns, skipping degenerate columns — the
    CheXpert protocol (`libs/training.py:225-237`)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    per = []
    for c in range(labels.shape[1]):
        col = labels[:, c]
        if col.min() == col.max():
            per.append(float("nan"))
            continue
        per.append(roc_auc(col, scores[:, c]))
    valid = [a for a in per if not np.isnan(a)]
    mean = float(np.mean(valid)) if valid else float("nan")
    if return_per_label:
        return mean, per
    return mean


def binary_confusion_stats(labels: np.ndarray, preds: np.ndarray) -> Dict:
    """accuracy / precision / recall / specificity / F1 + raw counts
    (`libs/training.py:24-59`)."""
    labels = np.asarray(labels).astype(bool).ravel()
    preds = np.asarray(preds).astype(bool).ravel()
    tp = int(np.sum(preds & labels))
    tn = int(np.sum(~preds & ~labels))
    fp = int(np.sum(preds & ~labels))
    fn = int(np.sum(~preds & labels))
    eps = 1e-12
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    return dict(
        tp=tp, tn=tn, fp=fp, fn=fn,
        accuracy=(tp + tn) / max(labels.size, 1),
        precision=precision,
        recall=recall,
        specificity=tn / (tn + fp + eps),
        f1=2 * precision * recall / (precision + recall + eps),
    )


def roc_curve_points(labels: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds) for ROC plotting (`2_inference_mura.py:263-324`
    artifact parity)."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    order = np.argsort(-scores, kind="mergesort")
    s = scores[order]
    l = labels[order]
    tps = np.cumsum(l)
    fps = np.cumsum(1 - l)
    # thresholds at distinct score boundaries
    distinct = np.where(np.diff(s))[0]
    idx = np.concatenate([distinct, [l.size - 1]])
    tpr = tps[idx] / max(tps[-1], 1)
    fpr = fps[idx] / max(fps[-1], 1)
    return (np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr]),
            np.concatenate([[np.inf], s[idx]]))
