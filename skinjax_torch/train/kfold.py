"""K-fold experiment runner (counterpart of ``skinjax/train/kfold.py``): the
reference's ``pipeline``/``run_expirements`` as a library function.

Per fold: group-stratified split (patients atomic) or stratified split →
train/val sources → ``train_process`` → artifacts (metrics CSV, prediction
CSV, audit arrays, plots where matplotlib is installed) → optional checkpoint.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from skinjax_torch.data.splits import stratified_group_kfold, stratified_kfold
from skinjax_torch.eval import artifacts
from skinjax_torch.train.checkpoint import save_checkpoint
from skinjax_torch.train.loop import TrainConfig, train_process


class SubsetSource:
    """Index-subset view over a source (the reference's per-fold dataset
    clones, without re-reading the CSV)."""

    def __init__(self, base, indices: np.ndarray):
        self.base = base
        self.indices = np.asarray(indices)
        self.labels = base.labels[self.indices]

    def __len__(self):
        return len(self.indices)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return self.base.batch(self.indices[np.asarray(idx)])

    def image_names(self) -> List[str]:
        if hasattr(self.base, "image_files"):
            return [self.base.image_files[i] for i in self.indices]
        return [str(i) for i in self.indices]


def run_kfold(
    model_factory: Callable[[], "torch.nn.Module"],  # noqa: F821
    source,
    labels: np.ndarray,
    groups: Optional[np.ndarray],
    num_classes: int,
    class_names: Sequence[str],
    config: TrainConfig = TrainConfig(),
    k_folds: int = 5,
    results_dir: str = "./results",
    model_name: str = "model",
    tracker=None,
    save_checkpoints: bool = False,
    folds: Optional[Sequence[int]] = None,
    resume: bool = False,
    mesh=None,
) -> List[Dict]:
    """Returns the per-fold final metric dicts. ``model_factory()`` builds a
    fresh, initialised model for each fold. ``resume=True`` gives each fold a
    checkpoint dir under ``results_dir`` for mid-training restart."""
    if groups is not None:
        split_iter = stratified_group_kfold(labels, groups, k_folds, seed=config.seed)
    else:
        split_iter = stratified_kfold(labels, k_folds, seed=config.seed)

    all_metrics: List[Dict] = []
    for fold_num, (train_idx, val_idx) in enumerate(split_iter, start=1):
        if folds is not None and fold_num not in folds:
            continue
        train_src = SubsetSource(source, train_idx)
        val_src = SubsetSource(source, val_idx)
        fold_dir = os.path.join(results_dir, f"{model_name}_fold_{fold_num}")

        run_ctx = (
            tracker.start_run(f"{model_name}_fold_{fold_num}")
            if tracker is not None and hasattr(tracker, "start_run")
            else contextlib.nullcontext()
        )
        with run_ctx:
            if tracker is not None:
                tracker.log_param("fold_num", fold_num)
                tracker.log_param("model_name", model_name)
            state, metrics, history = train_process(
                model_factory(), train_src, val_src, num_classes, config=config,
                tracker=tracker, fold_num=fold_num,
                resume_dir=os.path.join(fold_dir, "resume") if resume else None,
                mesh=mesh,
            )

        artifacts.save_audit_arrays(
            fold_dir, history["labels"], history["predictions"], history["probabilities"],
            np.asarray(class_names),
        )
        artifacts.save_metrics_csv(
            {"model": model_name, **metrics}, os.path.join(results_dir, "model_metrics.csv"),
        )
        artifacts.save_predictions_csv(
            os.path.join(fold_dir, f"predictions_eval_fold_{fold_num}.csv"),
            val_src.image_names(), history["labels"], history["predictions"],
            history["probabilities"], class_names,
        )
        artifacts.plot_confusion_matrix(
            history["labels"], history["predictions"], class_names,
            os.path.join(fold_dir, "confusion_matrix.png"),
        )
        artifacts.plot_roc_curves(
            history["labels"], history["probabilities"], class_names,
            os.path.join(fold_dir, "roc.png"),
        )
        artifacts.plot_loss_curves(
            history["train_loss"], history["val_loss"],
            os.path.join(fold_dir, "loss_curves.png"),
        )
        if save_checkpoints:
            save_checkpoint(os.path.join(fold_dir, "best"), state)
        all_metrics.append(metrics)
    return all_metrics
