"""Dynamic-batching frontend for the inference engine (counterpart of
``skinjax/serve/batching.py``, same semantics).

The reference serves one request per forward. Under concurrency a queue and
a batcher run one forward for many requests at a bounded latency cost.
``BatchingEngine`` wraps an ``InferenceEngine`` with the same ``predict``
surface:

  * a request is preprocessed on the host (resized to uint8; the engine
    normalizes it on the device), enqueued, and its caller blocks on an event;
  * one worker thread drains the queue: it groups up to ``max_batch``
    requests that arrive within ``max_wait_ms``, pads the group to the next
    power-of-two bucket, runs one forward and fans the results back out. The
    buckets bound the batch sizes the engine sees to log2(max_batch) + 1,
    and with them the K1–K4 launch plans the fusion kernels' wrappers cache
    a shape;
  * a request that finds the queue empty and no other direct call in flight
    runs its batch-1 forward in the caller's thread (no linger, no handoff);
  * a caller that times out marks its request abandoned, and the worker
    drops it instead of spending a forward on it;
  * an error in a batch's forward is raised in every caller of that batch;
    uint8 and float requests run in separate forwards, so an error in one
    does not reach the other.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from skinjax_torch.serve.engine import InferenceEngine, preprocess_image_u8


class _Pending:
    __slots__ = ("image", "feats", "event", "probs", "error", "abandoned")

    def __init__(self, image: np.ndarray, feats: np.ndarray):
        # an unbatched (H, W, 3) / (F,) request takes a batch axis here, so a
        # bare-rank request cannot fail the forward of the batch it lands in
        self.image = image if image.ndim == 4 else image[None]
        self.feats = feats if feats.ndim == 2 else feats[None]
        if self.image.shape[0] != 1 or self.feats.shape[0] != 1:
            raise ValueError("predict_probs_queued takes ONE request: image (1, H, W, 3) and "
                             f"feats (1, F); got {image.shape} / {feats.shape}")
        self.event = threading.Event()
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.abandoned = False  # set by a caller that gave up waiting


def _bucket(n: int, max_batch: int) -> int:
    """The smallest power of two ≥ n, at most ``max_batch``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class BatchingEngine:
    """``predict``-compatible wrapper of an ``InferenceEngine`` that batches
    concurrent requests."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 32, max_wait_ms: float = 5.0,
                 timeout_s: float = 60.0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.timeout_s = timeout_s
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._direct = threading.Lock()  # guards the fast path
        # written by the worker and by fast-path callers
        self._stats_lock = threading.Lock()
        # occupancy_sum / forward_s / idle_s tell a saturated worker from a
        # starved one
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0, "direct_requests": 0,
                      "occupancy_sum": 0, "forward_s": 0.0, "idle_s": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    @property
    def class_names(self):
        return self.engine.class_names

    def predict(self, image_u8: np.ndarray, metadata_csv_line: str) -> Dict:
        """Raw image (any size, uint8 HWC RGB) + raw CSV line → the
        ``POST /predict/`` response, through the queue."""
        image = preprocess_image_u8(image_u8)
        if self.engine.featurizer is None:
            raise ValueError("predict() on raw inputs requires a featurizer")
        feats = self.engine._featurize_csv_line(metadata_csv_line)
        probs = self.predict_probs_queued(image, feats)[0]
        idx = int(probs.argmax())
        names = self.engine.class_names
        return {
            "predicted_label_index": idx,
            "predicted_classname": names[idx] if names else str(idx),
            "probabilities": probs.tolist(),
        }

    def predict_probs_queued(self, image: np.ndarray, feats: np.ndarray) -> np.ndarray:
        """One preprocessed request (uint8 or normalized float image, its
        features) → its probabilities (1, classes); blocks until its batch
        ran, or runs it directly when the queue is idle."""
        p = _Pending(np.asarray(image), np.asarray(feats))
        if self._q.empty() and self._direct.acquire(blocking=False):
            try:
                if self._q.empty():
                    probs = self.engine.predict_probs(p.image, p.feats)
                    with self._stats_lock:
                        self.stats["requests"] += 1
                        self.stats["direct_requests"] += 1
                    return probs
            finally:
                self._direct.release()
        self._q.put(p)
        if not p.event.wait(self.timeout_s):
            p.abandoned = True
            raise TimeoutError("batched inference timed out")
        if p.error is not None:
            raise p.error
        return p.probs

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # -- worker ---------------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        t0 = time.perf_counter()
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            with self._stats_lock:
                self.stats["idle_s"] += time.perf_counter() - t0
            return []
        with self._stats_lock:
            self.stats["idle_s"] += time.perf_counter() - t0
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                group.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return group

    def _run(self):
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            subgroups: Dict[bool, List[_Pending]] = {}
            for p in group:
                if p.abandoned:
                    p.event.set()
                    continue
                subgroups.setdefault(p.image.dtype == np.uint8, []).append(p)
            for sub in subgroups.values():
                try:
                    n = len(sub)
                    b = _bucket(n, self.max_batch)
                    images = np.concatenate([p.image for p in sub] + [sub[-1].image] * (b - n))
                    feats = np.concatenate([p.feats for p in sub] + [sub[-1].feats] * (b - n))
                    tf = time.perf_counter()
                    probs = self.engine.predict_probs(images, feats)
                    tf = time.perf_counter() - tf
                    for i, p in enumerate(sub):
                        p.probs = probs[i:i + 1]
                    with self._stats_lock:
                        self.stats["requests"] += n
                        self.stats["batches"] += 1
                        self.stats["occupancy_sum"] += n
                        self.stats["forward_s"] += tf
                        if n > 1:
                            self.stats["batched_requests"] += n
                except Exception as e:  # noqa: BLE001 - raised in every caller
                    for p in sub:
                        p.error = e
                finally:
                    for p in sub:
                        p.event.set()
