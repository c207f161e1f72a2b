"""NAS search loops: REINFORCE / Bayesian-opt / LLM / random over DynamicCNN
(counterpart of ``skinjax/nas/search.py``).

The reference's 'controller-val-loss' variant
(nas/optimization_for_controller-val-loss_train_process_pad_20.py) differs
from the base REINFORCE loop only in the candidate trainer's early-stopping
metric (val_loss instead of val_bacc) — here that's
``TrainConfig(early_stopping_metric="val_loss")`` passed as ``train_cfg``.

The loop skeleton of nas/optimization_train_process_pad_20.py:220-389: 80/20
stratified split (seed 42), per-step candidate training via the standard
train_process (early stop on val_bacc), reward = balanced accuracy (failed
configs reward 0.0 and the search continues), best_config.json at the end.
``retrain_best`` re-trains a winning config with the full k-fold
(nas/train_pad_20_optimized_model.py). Training runs on ``train_cfg.device``
(``cuda`` unless the caller asks for the CPU), the REINFORCE controller with
it. skinjax's best-effort convergence plot is not drawn: the port has no
``eval/plots`` yet.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from skinjax_torch.data.splits import train_val_split
from skinjax_torch.nas import population
from skinjax_torch.nas.bayes_opt import GPSearch
from skinjax_torch.nas.controller import ReinforceSearch
from skinjax_torch.nas.dynamic_model import make_dynamic_model
from skinjax_torch.nas.llm_controller import LLMSearch
from skinjax_torch.nas.search_space import DEFAULT_SEARCH_SPACE, config_to_indices
from skinjax_torch.train.kfold import SubsetSource, run_kfold
from skinjax_torch.train.loop import TrainConfig, train_process


def _default_trainer(source, num_classes: int, train_cfg: TrainConfig, seed: int = 42):
    """Returns candidate_config -> reward (val balanced accuracy)."""
    labels = source.labels
    train_idx, val_idx = train_val_split(labels, val_fraction=0.2, seed=seed)
    train_src = SubsetSource(source, train_idx)
    val_src = SubsetSource(source, val_idx)

    def evaluate_candidate(config: Dict) -> float:
        model = make_dynamic_model(
            config, num_classes=num_classes, vocab_size=source.features.shape[1],
            seed=train_cfg.seed,
        )
        _, metrics, _ = train_process(
            model, train_src, val_src, num_classes, config=train_cfg
        )
        return float(metrics["balanced_accuracy"])

    return evaluate_candidate


def run_nas(
    source,
    num_classes: int,
    strategy: str = "reinforce",
    # reference default: SEARCH_STEPS = 500
    # (nas/optimization_train_process_pad_20.py:474)
    search_steps: int = 500,
    search_space: Optional[Dict] = None,
    train_cfg: Optional[TrainConfig] = None,
    evaluate_candidate: Optional[Callable[[Dict], float]] = None,
    results_dir: str = "./results/nas",
    llm_model_name: Optional[str] = None,
    tracker=None,
    seed: int = 42,
    population_size: int = 0,
    memoize: bool = True,
) -> Tuple[Dict, float, List[Dict]]:
    """Returns (best_config, best_reward, step_log); writes best_config.json.

    ``population_size > 1`` (reinforce/random strategies) samples that many
    candidates per outer iteration and trains each shape-bucket of them in
    ONE vmapped supernet step (nas/population.py) — across-candidate
    parallelism the reference's one-model-per-step loop cannot express.
    ``memoize`` caches rewards by exact config: the trainer
    is deterministic per (config, seed) — init and dropout keys derive from
    the config itself, not bucket position — so a re-sampled config (routine
    as a REINFORCE controller converges) costs nothing instead of a full
    training run where the reference retrains
    (nas/optimization_train_process_pad_20.py:308-337). Caveat: population
    and sequential rewards use different early-stop policies (population.py
    module docstring), so a memo warm-started across modes can shift a
    candidate's reward to the full-epochs value.
    """
    space = search_space or DEFAULT_SEARCH_SPACE
    train_cfg = train_cfg or TrainConfig(
        num_epochs=10, early_stopping_patience=5, early_stopping_metric="val_bacc",
    )
    evaluate_population: Optional[Callable] = None
    if population_size > 1 and evaluate_candidate is None:
        if strategy not in ("reinforce", "random"):
            raise ValueError(
                "population_size>1 supports strategies 'reinforce'/'random' "
                "(BO/LLM proposals are sequential by construction)"
            )
        evaluate_population = population.make_population_evaluator(
            source, num_classes, train_cfg=train_cfg, seed=seed,
        )
    if evaluate_candidate is None and evaluate_population is None:
        evaluate_candidate = _default_trainer(source, num_classes, train_cfg, seed)

    rng = np.random.default_rng(seed)
    if strategy == "reinforce":
        searcher = ReinforceSearch(space, seed=seed, device=train_cfg.device)
    elif strategy == "bo":
        searcher = GPSearch(space, seed=seed)
    elif strategy == "llm":
        if not llm_model_name:
            raise ValueError("strategy='llm' requires llm_model_name")
        searcher = LLMSearch(space, llm_model_name, seed=seed)
    elif strategy == "random":
        searcher = None
    else:
        raise ValueError(f"unknown NAS strategy '{strategy}'")

    best_cfg: Optional[Dict] = None
    best_reward = -float("inf")
    log: List[Dict] = []
    # deterministic trainer + fixed seed => a re-sampled config re-earns the
    # same reward WITHIN a mode (population dropout/init keys derive from the
    # config, not bucket position), so caching is semantics-preserving there;
    # across population/sequential modes rewards differ by early-stop policy
    memo: Dict[Tuple, float] = {}
    cfg_key = lambda c: tuple(sorted((k, str(v)) for k, v in c.items()))

    step = 0
    while step < search_steps:
        group = (
            min(population_size, search_steps - step)
            if evaluate_population is not None
            else 1
        )
        proposals: List[Tuple[Dict, Dict]] = []
        for _ in range(group):
            if strategy == "reinforce":
                config, indices = searcher.sample_config()
            elif strategy == "bo":
                config, indices = searcher.propose()
            elif strategy == "llm":
                config = searcher.propose()
                indices = config_to_indices(config, space)
            else:  # random
                config = {
                    k: v[int(rng.integers(len(v)))] for k, v in space.items()
                }
                indices = config_to_indices(config, space)
            proposals.append((config, indices))

        fresh = [
            i for i, (c, _) in enumerate(proposals)
            if not (memoize and cfg_key(c) in memo)
        ]
        # dedup fresh configs within the group (same key trains once)
        fresh_unique: Dict[Tuple, int] = {}
        for i in fresh:
            fresh_unique.setdefault(cfg_key(proposals[i][0]), i)
        # reward None == "this evaluation failed": the controller still sees
        # 0.0 (reference parity, optimization_train_process_pad_20.py:334),
        # but the failure is NOT memoized — a transient crash must not pin a
        # config at zero for the remaining search steps
        rewards_by_key: Dict[Tuple, Optional[float]] = {}
        if evaluate_population is not None and fresh_unique:
            group_rewards = evaluate_population(
                [proposals[i][0] for i in fresh_unique.values()]
            )
            for key, r in zip(fresh_unique.keys(), group_rewards):
                rewards_by_key[key] = r
        else:
            for key, i in fresh_unique.items():
                try:
                    rewards_by_key[key] = evaluate_candidate(proposals[i][0])
                except Exception as e:
                    print(f"[nas] step {step + i}: candidate failed "
                          f"({type(e).__name__}: {e})")
                    rewards_by_key[key] = None

        trained_now: set = set()
        for config, indices in proposals:
            key = cfg_key(config)
            if key in rewards_by_key and key not in trained_now:
                reward = rewards_by_key[key]
                trained_now.add(key)
                cached = False
            else:  # memo hit, or a within-group duplicate of a trained key
                reward = (
                    memo[key]
                    if memoize and key in memo
                    else rewards_by_key[key]
                )
                cached = True
            failed = reward is None
            if failed:
                reward = 0.0
            if memoize and not failed:
                memo[key] = reward

            if strategy == "reinforce":
                stats = searcher.update(indices, reward)
            elif strategy == "bo":
                searcher.observe(indices, reward)
                stats = {}
            elif strategy == "llm":
                searcher.observe(config, reward)
                stats = {}
            else:
                stats = {}

            if reward > best_reward:
                best_reward, best_cfg = reward, config
            entry = {"step": step, "config": config, "reward": reward, **stats}
            if cached:
                entry["cached"] = True
            if failed:
                entry["failed"] = True
            log.append(entry)
            if tracker:
                tracker.log_metric("reward", reward, step=step)
                tracker.log_metric("best_reward", best_reward, step=step)
            step += 1

    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "best_config.json"), "w") as f:
        json.dump({"config": best_cfg, "reward": best_reward}, f, indent=1, default=str)
    return best_cfg, best_reward, log


def retrain_best(
    source,
    labels,
    groups,
    num_classes: int,
    class_names,
    best_config_path: str,
    train_cfg: Optional[TrainConfig] = None,
    k_folds: int = 5,
    results_dir: str = "./results/nas_retrain",
) -> List[Dict]:
    """Full k-fold retrain of a best_config.json
    (nas/train_pad_20_optimized_model.py)."""
    with open(best_config_path) as f:
        best = json.load(f)["config"]
    return run_kfold(
        model_factory=lambda: make_dynamic_model(
            best, num_classes=num_classes, vocab_size=source.features.shape[1],
            seed=(train_cfg or TrainConfig()).seed,
        ),
        source=source, labels=labels, groups=groups, num_classes=num_classes,
        class_names=class_names, config=train_cfg or TrainConfig(),
        k_folds=k_folds, results_dir=results_dir, model_name="nas_best",
    )
