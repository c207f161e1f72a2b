"""Cross-validation splitters (pure numpy, deterministic; a copy of
``skinjax/data/splits.py``: the same folds for the same arguments).

Rebuilds the split strategies the reference takes from sklearn:
StratifiedKFold (train_isic_2020.py:223) and StratifiedGroupKFold by patient
(train_pad_20.py:239-241, seed 42). Implemented natively so split behaviour is
dependency-pinned; both are validated against sklearn in tests.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def stratified_kfold(
    labels: np.ndarray, n_splits: int = 5, seed: int = 42, shuffle: bool = True
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (train_idx, val_idx) with per-class round-robin fold assignment."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    fold_of = np.empty(len(labels), dtype=np.int32)
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        if shuffle:
            rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % n_splits
    for f in range(n_splits):
        val = np.flatnonzero(fold_of == f)
        train = np.flatnonzero(fold_of != f)
        yield train, val


def stratified_group_kfold(
    labels: np.ndarray,
    groups: np.ndarray,
    n_splits: int = 5,
    seed: int = 42,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Greedy stratified group k-fold: groups are atomic (a patient never
    appears in both train and val); groups are assigned — largest first, ties
    shuffled — to the fold where they least worsen the per-class deviation
    from the global distribution. Same objective as sklearn's
    StratifiedGroupKFold, deterministic under ``seed``."""
    labels = np.asarray(labels)
    groups = np.asarray(groups)
    classes, y = np.unique(labels, return_inverse=True)
    n_classes = len(classes)
    uniq_groups, g = np.unique(groups, return_inverse=True)

    # per-group class histograms
    counts = np.zeros((len(uniq_groups), n_classes), dtype=np.int64)
    np.add.at(counts, (g, y), 1)

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(uniq_groups))
    # largest groups first (stable by shuffled tiebreak)
    order = order[np.argsort(-counts[order].sum(axis=1), kind="stable")]

    fold_counts = np.zeros((n_splits, n_classes), dtype=np.int64)
    fold_of_group = np.empty(len(uniq_groups), dtype=np.int32)
    total = counts.sum(axis=0).astype(np.float64)
    total[total == 0] = 1.0

    for gi in order:
        best_fold, best_cost = 0, np.inf
        for f in range(n_splits):
            trial = fold_counts.copy()
            trial[f] += counts[gi]
            frac = trial / total  # (folds, classes)
            cost = frac.std(axis=0).mean()
            if cost < best_cost:
                best_cost, best_fold = cost, f
        fold_of_group[gi] = best_fold
        fold_counts[best_fold] += counts[gi]

    fold_of = fold_of_group[g]
    for f in range(n_splits):
        val = np.flatnonzero(fold_of == f)
        train = np.flatnonzero(fold_of != f)
        yield train, val


def train_val_split(
    labels: np.ndarray, val_fraction: float = 0.2, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Single stratified split (the NAS loops' 80/20,
    nas/optimization_train_process_pad_20.py:232-237)."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    train_idx, val_idx = [], []
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        n_val = max(1, int(round(len(idx) * val_fraction)))
        val_idx.append(idx[:n_val])
        train_idx.append(idx[n_val:])
    return np.concatenate(train_idx), np.concatenate(val_idx)
