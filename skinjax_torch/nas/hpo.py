"""Hyperparameter tuning — the Optuna role
(interpretability/fine_tunne_hyperparameters.py:151-218: text-MLP hidden
sizes/dropout, num_heads ∈ {4..512}, fusion-MLP sizes, 50 trials minimizing
val loss) on the native GP-EI searcher.

A copy of ``skinjax/nas/hpo.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from skinjax_torch.nas.bayes_opt import GPSearch

# the reference's tuning space (fine_tunne_hyperparameters.py:151-218)
DEFAULT_HPO_SPACE: Dict[str, Sequence] = {
    "text_hidden_1": [128, 256, 512],
    "text_hidden_2": [256, 512, 1024],
    "text_dropout": [0.0, 0.1, 0.3, 0.5],
    "num_heads": [4, 8, 16, 32, 64, 128, 256, 512],
    "fusion_hidden": [256, 512, 1024],
    "fusion_dropout": [0.3, 0.5],
    "learning_rate": [1e-5, 5e-5, 1e-4, 5e-4],
}


def tune_hyperparameters(
    objective: Callable[[Dict], float],
    space: Optional[Dict[str, Sequence]] = None,
    n_trials: int = 50,
    direction: str = "minimize",
    seed: int = 42,
    strategy: str = "gp",
) -> Tuple[Dict, float, List[Dict]]:
    """Returns (best_params, best_value, trial_log). ``objective`` maps a
    sampled param dict to the metric (val loss by default, minimized)."""
    space = {k: list(v) for k, v in (space or DEFAULT_HPO_SPACE).items()}
    sign = -1.0 if direction == "minimize" else 1.0

    if strategy == "gp":
        searcher = GPSearch(space, seed=seed, n_initial=min(8, n_trials))
    elif strategy == "random":
        searcher = None
        import numpy as np

        rng = np.random.default_rng(seed)
    else:
        raise ValueError(f"unknown HPO strategy '{strategy}'")

    log: List[Dict] = []
    best_params: Optional[Dict] = None
    best_value = float("inf") if direction == "minimize" else -float("inf")

    for trial in range(n_trials):
        if searcher is not None:
            params, indices = searcher.propose()
        else:
            params = {k: v[int(rng.integers(len(v)))] for k, v in space.items()}
            indices = None
        try:
            value = float(objective(params))
        except Exception as e:
            print(f"[hpo] trial {trial} failed ({type(e).__name__}: {e})")
            value = float("inf") if direction == "minimize" else -float("inf")
        if searcher is not None and indices is not None:
            import math

            searcher.observe(indices, sign * (0.0 if not math.isfinite(value) else value))
        better = value < best_value if direction == "minimize" else value > best_value
        if better:
            best_value, best_params = value, params
        log.append({"trial": trial, "params": params, "value": value})
    return best_params, best_value, log
