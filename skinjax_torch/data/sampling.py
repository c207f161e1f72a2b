"""Class weighting + deterministic weighted resampling (a numpy-only copy of
``skinjax/data/sampling.py``: the same arrays for the same arguments).

Rebuilds ``compute_class_weights`` (train_pad_20.py:22-32: w_k = N/(K·n_k))
and the epoch-level ``WeightedRandomSampler`` (train_pad_20.py:293-302) in a
form that is deterministic per (seed, epoch) and shardable across
data-parallel hosts: every host computes the same permutation and takes its
own contiguous slice, so no sampler state needs to be communicated.
"""

from __future__ import annotations

import numpy as np


def compute_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """w_k = N / (K * n_k); absent classes get weight 0 (train_pad_20.py:22-32)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=num_classes)
    total = len(labels)
    weights = np.zeros(num_classes, dtype=np.float32)
    nz = counts > 0
    weights[nz] = total / (num_classes * counts[nz])
    return weights


def weighted_sample_indices(
    labels: np.ndarray,
    num_classes: int,
    num_samples: int,
    seed: int,
    epoch: int = 0,
) -> np.ndarray:
    """Sample-with-replacement by class weight (WeightedRandomSampler parity):
    per-sample probability ∝ w_{class(sample)}. Deterministic per (seed, epoch)."""
    labels = np.asarray(labels)
    class_w = compute_class_weights(labels, num_classes)
    sample_w = class_w[labels].astype(np.float64)
    p = sample_w / sample_w.sum()
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(epoch) * np.uint64(0x9E3779B9))
    return rng.choice(len(labels), size=num_samples, replace=True, p=p)


def epoch_batches(
    labels: np.ndarray,
    num_classes: int,
    batch_size: int,
    seed: int,
    epoch: int,
    weighted: bool = True,
    drop_remainder: bool = True,
) -> np.ndarray:
    """Return an (num_batches, batch_size) index matrix for one epoch.

    Weighted mode resamples to len(labels) like the reference sampler; static
    batch count/shape keeps XLA free of recompiles.
    """
    n = len(labels)
    if weighted:
        idx = weighted_sample_indices(labels, num_classes, n, seed, epoch)
    else:
        rng = np.random.default_rng(np.uint64(seed) + np.uint64(epoch) * np.uint64(0x9E3779B9))
        idx = rng.permutation(n)
    if drop_remainder:
        n_batches = n // batch_size
        idx = idx[: n_batches * batch_size]
    else:  # pad by wrapping so the last batch keeps a static shape
        n_batches = -(-n // batch_size)
        pad = n_batches * batch_size - n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
    return idx.reshape(n_batches, batch_size)
