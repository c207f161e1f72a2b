"""XAI reporting: flip-rate barplots and transition heatmaps, per-feature
uncertainty tables, missing-data degradation plots (counterpart of
``skinjax/xai/reports.py``).

``per_feature_uncertainty`` is numpy. The plots import pyplot on first use,
as ``eval/artifacts.py`` does: where matplotlib is not installed (the card's
machine), a plot is not written and a note says so.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from skinjax_torch.eval.artifacts import _plt
from skinjax_torch.xai.perturbation import faithfulness_degradation_score, prediction_uncertainty


def per_feature_uncertainty(flip_results: Dict) -> List[Dict]:
    """Expand run_flip_analysis output into per-feature uncertainty + FDS rows
    (the reference's per-feature uncertainty variant)."""
    base = flip_results["base_probs"]
    rows = []
    for feature, r in flip_results["mutations"].items():
        u = prediction_uncertainty(base, r["probs"])
        rows.append({
            "feature": feature,
            "flip_rate": r["flip_rate"],
            "fds": faithfulness_degradation_score(base, r["probs"]),
            **u,
        })
    rows.sort(key=lambda x: -x["fds"])
    return rows


def flip_rate_barplot(flip_results: Dict, path: str) -> None:
    plt = _plt(path)
    if plt is None:
        return
    items = sorted(
        flip_results["mutations"].items(), key=lambda kv: -kv[1]["flip_rate"]
    )
    names = [k for k, _ in items]
    rates = [v["flip_rate"] for _, v in items]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.5), 4))
    ax.bar(range(len(names)), rates)
    ax.set_xticks(range(len(names)), names, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("flip rate")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def transition_heatmap(
    flip_results: Dict, feature: str, class_names: Sequence[str], path: str
) -> None:
    plt = _plt(path)
    if plt is None:
        return
    trans = flip_results["mutations"][feature]["transition_matrix"].astype(float)
    rows = trans.sum(axis=1, keepdims=True)
    norm = np.divide(trans, rows, out=np.zeros_like(trans), where=rows > 0)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(norm, cmap="viridis")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45, fontsize=7)
    ax.set_yticks(range(len(class_names)), class_names, fontsize=7)
    for i in range(norm.shape[0]):
        for j in range(norm.shape[1]):
            ax.text(j, i, f"{norm[i, j]:.2f}", ha="center", va="center",
                    fontsize=6, color="w")
    ax.set_xlabel(f"prediction after {feature} intervention")
    ax.set_ylabel("baseline prediction")
    fig.colorbar(im)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def degradation_comparison_plot(
    sweeps: Dict[str, List[Dict]], path: str, metric: str = "balanced_accuracy"
) -> None:
    """{model_name: missing_data_sweep rows} -> metric-vs-rate line plot."""
    plt = _plt(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, rows in sweeps.items():
        rates = [r["missing_rate"] for r in rows]
        vals = [r[metric] for r in rows]
        ax.plot(rates, vals, marker="o", label=name)
    ax.set_xlabel("missing-metadata rate")
    ax.set_ylabel(metric)
    ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
