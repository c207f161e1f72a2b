"""Host-side input pipeline (numpy only; counterpart of
``skinjax/data/pipeline.py``): in-memory sources, the synthetic dataset and a
background prefetch thread. Augmentation runs on the device
(``skinjax_torch.data.augment``); the host only assembles uint8 batches.

``synthetic_source`` gives the same arrays as skinjax's for the same
arguments. The disk-backed ``ImageStore``/``FileSource`` (which decode with
OpenCV in skinjax) and the sentence datasets' ``TokenSource`` are not ported
yet; ROADMAP.md lists them with the train CLI.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class ArraySource:
    """In-memory data source: images (N,H,W,3) uint8 + features + labels.
    Used for synthetic data (tests/smoke runs) and for fully-cached datasets."""

    def __init__(self, images: np.ndarray, features: np.ndarray, labels: np.ndarray):
        if not len(images) == len(features) == len(labels):
            raise ValueError(f"lengths differ: {len(images)} images, {len(features)} "
                             f"feature rows, {len(labels)} labels")
        self.images = images
        self.features = features.astype(np.float32)
        self.labels = labels.astype(np.int32)

    def __len__(self):
        return len(self.images)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "image": self.images[idx],
            "metadata": self.features[idx],
            "label": self.labels[idx],
        }


def synthetic_source(
    n: int = 256,
    image_size=(224, 224),
    feature_dim: int = 91,
    num_classes: int = 6,
    seed: int = 0,
) -> ArraySource:
    """Random-but-deterministic dataset with class-conditional signal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = rng.integers(0, 256, size=(n, *image_size, 3), dtype=np.uint8)
    # plant a per-class brightness signal so learning is testable
    images = np.clip(
        images.astype(np.int32) + (labels * 12)[:, None, None, None], 0, 255
    ).astype(np.uint8)
    features = rng.normal(size=(n, feature_dim)).astype(np.float32)
    features[np.arange(n), labels % feature_dim] += 2.0
    return ArraySource(images, features, labels)


def prefetch_batches(
    source, index_matrix: np.ndarray, prefetch: int = 4
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches for the given (num_batches, B) index matrix, assembled on
    a daemon thread ahead of consumption."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()
    cancelled = threading.Event()
    error: list = []

    def _put(item) -> bool:
        # bounded put that re-checks cancellation, so an abandoned consumer
        # (break / exception in the train loop) can't strand the producer
        # blocked forever on a full queue
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for row in index_matrix:
                if cancelled.is_set() or not _put(source.batch(row)):
                    return
        except BaseException as e:  # surface loader failures to the consumer
            error.append(e)
        finally:
            _put(stop)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        cancelled.set()
