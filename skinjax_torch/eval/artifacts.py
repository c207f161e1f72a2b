"""Run artifacts: metrics CSV, per-sample prediction CSVs, npy audit arrays,
confusion-matrix / ROC / loss-curve plots (counterpart of
``skinjax/eval/artifacts.py``: the same files).

Rebuilds utils/save_model_and_metrics.py:16-173 and utils/save_predictions.py:
7-104 — append-mode ``model_metrics.csv``, ``predictions_eval_fold_N.csv``
with per-class probabilities, the labels/predictions/probabilities/targets
``.npy`` audit trail (model_metrics.py:83-86), and the three PNGs.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from skinjax_torch.train.metrics import confusion_matrix


def save_metrics_csv(metrics: Dict, path: str) -> None:
    """Append one row; header written on first create (save_model_and_metrics.py:71-80)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(metrics.keys()))
        if not exists:
            writer.writeheader()
        writer.writerow(metrics)


def save_audit_arrays(
    folder: str, labels, predictions, probabilities, targets
) -> None:
    os.makedirs(folder, exist_ok=True)
    np.save(os.path.join(folder, "labels.npy"), np.asarray(labels))
    np.save(os.path.join(folder, "predictions.npy"), np.asarray(predictions))
    np.save(os.path.join(folder, "probabilities.npy"), np.asarray(probabilities))
    np.save(os.path.join(folder, "targets.npy"), np.asarray(targets))


def save_predictions_csv(
    path: str,
    image_names: Sequence[str],
    labels: np.ndarray,
    predictions: np.ndarray,
    probabilities: np.ndarray,
    class_names: Sequence[str],
) -> None:
    """Per-sample eval CSV with per-class probability columns
    (save_predictions.py:45-65)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["image_name", "label", "prediction"]
            + [f"prob_{c}" for c in class_names]
        )
        for i, name in enumerate(image_names):
            writer.writerow(
                [name, int(labels[i]), int(predictions[i])]
                + [f"{p:.6f}" for p in probabilities[i]]
            )


def _plt(path: str):
    """matplotlib's pyplot, imported on first use; None, with a note, when
    matplotlib is not installed (the CSVs and arrays do not need it)."""
    try:
        import matplotlib
    except ImportError:
        print(f"[artifacts] matplotlib is not installed; {path} is not written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(
    labels, predictions, class_names: Sequence[str], path: str, normalize: bool = True
) -> None:
    plt = _plt(path)
    if plt is None:
        return
    cm = confusion_matrix(labels, predictions, len(class_names)).astype(np.float64)
    if normalize:
        rows = cm.sum(axis=1, keepdims=True)
        cm = np.divide(cm, rows, out=np.zeros_like(cm), where=rows > 0)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm, cmap="Blues", vmin=0)
    ax.set_xticks(range(len(class_names)), class_names, rotation=45)
    ax.set_yticks(range(len(class_names)), class_names)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}", ha="center", va="center", fontsize=8)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_roc_curves(
    labels, probabilities, class_names: Sequence[str], path: str
) -> None:
    plt = _plt(path)
    if plt is None:
        return
    labels = np.asarray(labels)
    probabilities = np.asarray(probabilities)
    fig, ax = plt.subplots(figsize=(6, 5))
    for c, name in enumerate(class_names):
        pos = (labels == c).astype(np.int32)
        if pos.sum() == 0 or pos.sum() == len(pos):
            continue
        order = np.argsort(-probabilities[:, c], kind="mergesort")
        tps = np.cumsum(pos[order])
        fps = np.cumsum(1 - pos[order])
        tpr = tps / max(tps[-1], 1)
        fpr = fps / max(fps[-1], 1)
        ax.plot(fpr, tpr, label=name)
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_loss_curves(
    train_losses: List[float], val_losses: List[float], path: str
) -> None:
    plt = _plt(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(train_losses, label="train")
    ax.plot(val_losses, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
