"""Bayesian-optimization architecture search — the skopt ``gp_minimize`` role
(nas/optimization_train_process_pad_20_using_BO.py:28-435) as a native,
seeded GP-EI optimizer over the discrete search space.

Configs are one-hot encoded; a GP with RBF kernel + observation noise is fit
on the evaluated points; candidates are proposed by maximizing Expected
Improvement over a random candidate pool (exact EI maximization over a
discrete product space is itself NP-hard — pool sampling is what skopt's
acq_optimizer='sampling' does too).

A copy of ``skinjax/nas/bayes_opt.py`` (numpy only; importing ``skinjax.nas``
imports JAX), so that a seed proposes the same configs in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from skinjax_torch.nas.search_space import indices_to_config


class GPSearch:
    def __init__(
        self,
        search_space: Dict[str, Sequence],
        seed: int = 42,
        n_initial: int = 8,
        pool_size: int = 512,
        length_scale: float = 1.0,
        noise: float = 1e-3,
    ):
        self.space = {k: list(v) for k, v in search_space.items()}
        self.keys = list(self.space)
        self.rng = np.random.default_rng(seed)
        self.n_initial = n_initial
        self.pool_size = pool_size
        self.length_scale = length_scale
        self.noise = noise
        self.X: List[np.ndarray] = []
        self.y: List[float] = []
        self.configs: List[Dict] = []

    # -- encoding -----------------------------------------------------------
    def _encode(self, indices: Dict[str, int]) -> np.ndarray:
        parts = []
        for k in self.keys:
            v = np.zeros(len(self.space[k]))
            v[indices[k]] = 1.0
            parts.append(v)
        return np.concatenate(parts)

    def _random_indices(self) -> Dict[str, int]:
        return {k: int(self.rng.integers(len(self.space[k]))) for k in self.keys}

    # -- GP core ------------------------------------------------------------
    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale**2)

    def _posterior(self, Xcand: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        X = np.stack(self.X)
        y = np.asarray(self.y)
        mu0 = y.mean()
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Ks = self._kernel(Xcand, X)
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y - mu0))
        mu = mu0 + Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(axis=0), 1e-10, None)
        return mu, np.sqrt(var)

    # -- public API -----------------------------------------------------------
    def propose(self) -> Tuple[Dict, Dict[str, int]]:
        """Next config to evaluate (random during warmup, EI afterwards)."""
        if len(self.X) < self.n_initial:
            idx = self._random_indices()
            return indices_to_config(idx, self.space), idx

        pool = [self._random_indices() for _ in range(self.pool_size)]
        Xc = np.stack([self._encode(i) for i in pool])
        mu, sd = self._posterior(Xc)
        best = max(self.y)
        z = (mu - best) / sd
        from math import erf, sqrt

        Phi = 0.5 * (1.0 + np.vectorize(lambda t: erf(t / sqrt(2.0)))(z))
        phi = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        ei = (mu - best) * Phi + sd * phi
        idx = pool[int(np.argmax(ei))]
        return indices_to_config(idx, self.space), idx

    def observe(self, indices: Dict[str, int], reward: float) -> None:
        self.X.append(self._encode(indices))
        self.y.append(float(reward))
        self.configs.append(indices_to_config(indices, self.space))

    @property
    def best(self) -> Tuple[Optional[Dict], float]:
        if not self.y:
            return None, -float("inf")
        i = int(np.argmax(self.y))
        return self.configs[i], self.y[i]
