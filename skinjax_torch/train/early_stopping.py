"""Early stopping with best-weights retention (counterpart of
``skinjax/train/early_stopping.py``).

min-val_loss or max-val_bacc modes, a ``delta`` improvement margin with the
reference's comparison (``score < best + delta`` counts as no improvement),
counter reset on improvement. The best state is whatever the caller snapshots
on improvement; the fold loop keeps an on-device clone of the model's
``state_dict()`` (parameters and BatchNorm buffers).
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class EarlyStopping:
    def __init__(
        self,
        patience: int = 7,
        delta: float = 0.0,
        metric_name: str = "val_loss",  # or "val_bacc"
        verbose: bool = False,
        on_improvement: Optional[Callable[[Any], None]] = None,
    ):
        if metric_name not in ("val_loss", "val_bacc"):
            raise ValueError(f"Unsupported early stopping metric: {metric_name}")
        self.patience = patience
        self.delta = delta
        self.metric_name = metric_name
        self.verbose = verbose
        self.on_improvement = on_improvement
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.best_state: Any = None

    def __call__(self, *, val_loss: float, val_bacc: float, state: Any) -> bool:
        """Record an epoch result; returns True if this epoch improved.

        ``state`` may be the state itself or a zero-arg callable returning it
        (a lazy snapshot, taken only on improvement)."""
        score = -float(val_loss) if self.metric_name == "val_loss" else float(val_bacc)
        if self.best_score is not None and score < self.best_score + self.delta:
            self.counter += 1
            if self.verbose:
                print(
                    f"EarlyStopping counter: {self.counter}/{self.patience} "
                    f"({self.metric_name}: {score:.6f} vs best {self.best_score:.6f})"
                )
            if self.counter >= self.patience:
                self.early_stop = True
            return False
        self.best_score = score
        self.best_state = state() if callable(state) else state
        self.counter = 0
        if self.on_improvement is not None:
            self.on_improvement(state)
        return True

    def load_best(self, fallback: Any):
        return self.best_state if self.best_state is not None else fallback
