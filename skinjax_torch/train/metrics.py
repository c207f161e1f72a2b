"""Evaluation metrics in pure numpy with sklearn-identical semantics (a copy
of ``skinjax/train/metrics.py``).

Rebuilds utils/model_metrics.py:15-134: accuracy, balanced accuracy,
precision/recall/F1 (binary or weighted multiclass, zero_division=0) and
ROC-AUC (binary, or weighted one-vs-rest multiclass; returns None when not
computable — the reference's try/except guard at model_metrics.py:103-119).
Validated against sklearn in tests; implemented natively so the metric path
has no sklearn dependency at serving time.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, int), np.asarray(y_pred, int)), 1)
    return cm


def _prf(cm: np.ndarray):
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(true_pos > 0, tp / true_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, true_pos


def binary_roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney U formulation with midrank tie handling (== sklearn)."""
    y_true = np.asarray(y_true).astype(bool)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("only one class present")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = np.asarray(scores)[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[y_true].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def roc_auc(y_true: np.ndarray, probs: np.ndarray) -> Optional[float]:
    """Binary: AUC of probs[:, 1]; multiclass: weighted OvR. None if degenerate."""
    probs = np.asarray(probs)
    y_true = np.asarray(y_true)
    num_classes = probs.shape[1]
    try:
        if num_classes == 2:
            return binary_roc_auc(y_true == 1, probs[:, 1])
        aucs, weights = [], []
        for c in range(num_classes):
            pos = y_true == c
            aucs.append(binary_roc_auc(pos, probs[:, c]))
            weights.append(pos.sum())
        weights = np.asarray(weights, dtype=np.float64)
        return float(np.average(aucs, weights=weights))
    except ValueError:
        return None


def classification_metrics(
    y_true: np.ndarray, y_pred: np.ndarray, probs: Optional[np.ndarray] = None,
    num_classes: Optional[int] = None, fold: Optional[int] = None,
) -> Dict[str, Optional[float]]:
    """The reference's metric dict (model_metrics.py:120-132)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if num_classes is None:
        num_classes = probs.shape[1] if probs is not None else int(
            max(y_true.max(), y_pred.max()) + 1
        )
    cm = confusion_matrix(y_true, y_pred, num_classes)
    precision, recall, f1, support = _prf(cm)

    accuracy = float((y_true == y_pred).mean())
    present = support > 0
    balanced_accuracy = float(recall[present].mean()) if present.any() else 0.0

    if num_classes == 2:
        p, r, f = float(precision[1]), float(recall[1]), float(f1[1])
    else:
        w = support / max(support.sum(), 1.0)
        p = float((precision * w).sum())
        r = float((recall * w).sum())
        f = float((f1 * w).sum())

    auc = roc_auc(y_true, probs) if probs is not None else None
    out: Dict[str, Optional[float]] = {
        "accuracy": accuracy,
        "balanced_accuracy": balanced_accuracy,
        "precision": p,
        "recall": r,
        "f1_score": f,
        "auc": auc,
    }
    if fold is not None:
        out = {"fold": fold, **out}
    return out
