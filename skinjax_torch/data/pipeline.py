"""Host-side input pipeline (counterpart of ``skinjax/data/pipeline.py``):
the disk-backed image store, in-memory and disk-backed sources, the
synthetic dataset and a background prefetch thread. Augmentation runs on the
device (``skinjax_torch.data.augment``); the host only assembles uint8
batches.

``ImageStore`` decodes each image once and keeps it resized to the model's
input size. skinjax decodes with OpenCV, which the card's machine lacks; the
port decodes PNG with the stdlib reader of ``skinjax_torch.serve.png`` and
resizes on the host with OpenCV's ``INTER_LINEAR`` rule (half-pixel
centres, no antialias, ``serve.engine.resize_u8``), within one level of
OpenCV. A JPEG or a PNG kind that reader does not decode raises
``UnsupportedImage``. That reader unfilters the Average and Paeth rows in a
Python loop, so decoding a photograph is slow (PERF.md).

``synthetic_source`` gives the same arrays as skinjax's for the same
arguments. ``TokenSource`` serves the sentence datasets: its batches'
metadata is ``{"input_ids", "attention_mask"}``, int32.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from skinjax_torch.serve import png
from skinjax_torch.serve.engine import resize_u8


class UnsupportedImage(ValueError):
    """An image file the port cannot decode (only PNG is read)."""


class ImageStore:
    """Decode-once uint8 image cache keyed by file name."""

    def __init__(self, img_dir: str, size=(224, 224), cache: bool = True):
        self.img_dir = img_dir
        self.size = tuple(size)
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache else None

    def _load(self, name: str) -> np.ndarray:
        path = os.path.join(self.img_dir, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Imagem inválida: {path}")
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(png.PNG_SIGNATURE):
            raise UnsupportedImage(
                f"{path}: not a PNG; the port decodes PNG only (JPEG datasets wait for a "
                "decoder on the card's machine, ROADMAP.md)")
        try:
            img = png.decode_png(data)
        except png.UnsupportedPNG as e:
            raise UnsupportedImage(f"{path}: {e}") from e
        if img.shape[:2] != self.size:
            img = resize_u8(torch.from_numpy(img), self.size).numpy()
        return np.ascontiguousarray(img, dtype=np.uint8)

    def get(self, name: str) -> np.ndarray:
        if self._cache is None:
            return self._load(name)
        hit = self._cache.get(name)
        if hit is None:
            hit = self._cache[name] = self._load(name)
        return hit

    def gather(self, names: Sequence[str]) -> np.ndarray:
        return np.stack([self.get(n) for n in names])


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


class FileSource:
    """Disk-backed source: ImageStore + featurized metadata arrays."""

    def __init__(self, store: ImageStore, image_files: Sequence[str], features: np.ndarray,
                 labels: np.ndarray):
        self.store = store
        self.image_files = list(image_files)
        self.features = features.astype(np.float32)
        self.labels = labels.astype(np.int32)

    def __len__(self):
        return len(self.image_files)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "image": self.store.gather([self.image_files[i] for i in idx]),
            "metadata": self.features[idx],
            "label": self.labels[idx],
        }


class TokenSource:
    """Source for the sentence-metadata datasets: images (an (N, H, W, 3)
    uint8 array, or an ``ImageStore`` and file names) + tokenized sentences
    (input_ids/attention_mask) + labels. A batch's metadata is a dict of
    int32 arrays, which the train and eval steps take."""

    def __init__(self, images_or_store, image_files, input_ids: np.ndarray,
                 attention_mask: np.ndarray, labels: np.ndarray):
        self._store = None
        self._images = None
        if isinstance(images_or_store, np.ndarray):
            self._images = images_or_store
        else:
            self._store = images_or_store
            self._files = list(image_files)
        self.input_ids = input_ids.astype(np.int32)
        self.attention_mask = attention_mask.astype(np.int32)
        self.labels = labels.astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def batch(self, idx: np.ndarray) -> Dict[str, object]:
        idx = np.asarray(idx)
        if self._images is not None:
            imgs = self._images[idx]
        else:
            imgs = self._store.gather([self._files[i] for i in idx])
        return {
            "image": imgs,
            "metadata": {
                "input_ids": self.input_ids[idx],
                "attention_mask": self.attention_mask[idx],
            },
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
