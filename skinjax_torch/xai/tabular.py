"""Tabular explainers: LIME (continuous and categorical), KernelSHAP and
permutation importance (the port's own copy of ``skinjax/xai/tabular.py``,
numpy only).

Rebuilds of the reference's lime/shap glue (lime_padufes20.py:10-140,
shap_values.py:97-181) without the ``lime``/``shap`` packages: each method
draws its perturbations with numpy from its seed and asks a
``predict_probs(features) -> probs`` callable for all of them at once (a
batched forward on the card), so at the same seed and predictor it returns
skinjax's numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np


def lime_tabular(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    class_idx: int,
    num_samples: int = 1000,
    kernel_width: Optional[float] = None,
    feature_sigma: Optional[np.ndarray] = None,
    seed: int = 0,
) -> np.ndarray:
    """Local linear surrogate around sample ``x`` (F,) for one class.

    Perturb x with Gaussian noise, weight samples by an RBF kernel on
    distance, fit weighted ridge regression on the class probability.
    Returns per-feature attribution weights (F,).
    """
    rng = np.random.default_rng(seed)
    F = x.shape[0]
    sigma = feature_sigma if feature_sigma is not None else np.ones(F)
    Z = x[None] + rng.normal(size=(num_samples, F)) * sigma[None]
    Z[0] = x
    y = predict_probs(Z.astype(np.float32))[:, class_idx]

    d = np.sqrt(((Z - x[None]) / np.maximum(sigma, 1e-8)) ** 2).sum(axis=1)
    kw = kernel_width if kernel_width is not None else np.sqrt(F) * 0.75
    w = np.exp(-(d**2) / (kw**2))

    Zc = Z - Z.mean(axis=0)
    yc = y - y.mean()
    W = np.diag(w)
    A = Zc.T @ W @ Zc + 1e-3 * np.eye(F)
    b = Zc.T @ W @ yc
    return np.linalg.solve(A, b)


def lime_tabular_categorical(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    class_idx: int,
    training_data: np.ndarray,
    categorical_idx: Sequence[int],
    num_samples: int = 1000,
    kernel_width: Optional[float] = None,
    seed: int = 0,
) -> np.ndarray:
    """LIME with categorical sampling semantics (lime.lime_tabular with
    ``categorical_features``; the reference's explainer call is
    lime_padufes20.py:84-116 over the one-hot feature space).

    Per LIME's algorithm: categorical features are resampled from their
    *training frequency* distribution; the surrogate design matrix uses the
    binary match indicator (1 if the perturbed value equals the instance's)
    instead of the raw value; continuous features perturb Gaussian scaled by
    the training std. Returns per-feature attribution weights (F,).
    """
    rng = np.random.default_rng(seed)
    F = x.shape[0]
    cat = np.zeros(F, dtype=bool)
    cat[np.asarray(list(categorical_idx), dtype=int)] = True
    std = training_data.std(axis=0)

    Z = np.tile(x[None], (num_samples, 1)).astype(np.float64)
    # continuous: Gaussian around the instance, scaled by training std
    cont = ~cat
    if cont.any():
        Z[:, cont] = x[cont][None] + rng.normal(
            size=(num_samples, int(cont.sum()))
        ) * np.maximum(std[cont], 1e-8)[None]
    # categorical: draw from the column's empirical training distribution
    for j in np.where(cat)[0]:
        vals, counts = np.unique(training_data[:, j], return_counts=True)
        Z[:, j] = rng.choice(vals, size=num_samples, p=counts / counts.sum())
    Z[0] = x

    y = predict_probs(Z.astype(np.float32))[:, class_idx]

    # interpretable representation: binary match for categoricals,
    # std-normalized value for continuous (LIME's data_inverse convention)
    X_int = np.empty_like(Z)
    X_int[:, cat] = (Z[:, cat] == x[cat][None]).astype(np.float64)
    if cont.any():
        X_int[:, cont] = (Z[:, cont] - x[cont][None]) / np.maximum(
            std[cont], 1e-8
        )[None]

    ref = np.empty(F)
    ref[cat] = 1.0  # the instance matches itself
    ref[cont] = 0.0
    d = np.sqrt(((X_int - ref[None]) ** 2).sum(axis=1))
    kw = kernel_width if kernel_width is not None else np.sqrt(F) * 0.75
    w = np.exp(-(d**2) / (kw**2))

    # center with the kernel-WEIGHTED means: with non-uniform proximity
    # weights the unweighted mean mis-handles the intercept of the ridge fit
    # (weighted least squares absorbs the intercept only when X/y are
    # weighted-centered)
    wsum = max(w.sum(), 1e-12)
    Xc = X_int - (w[:, None] * X_int).sum(axis=0) / wsum
    yc = y - (w * y).sum() / wsum
    A = Xc.T @ (w[:, None] * Xc) + 1e-3 * np.eye(F)
    b = Xc.T @ (w * yc)
    return np.linalg.solve(A, b)


def kernel_shap(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    background: np.ndarray,
    class_idx: int,
    num_samples: int = 2048,
    seed: int = 0,
) -> np.ndarray:
    """KernelSHAP estimate of per-feature Shapley values for one sample.

    Coalitions z ∈ {0,1}^F drawn with Shapley kernel-distributed sizes;
    masked features are replaced by the background mean. Solves the weighted
    least squares with the sum-to-(f(x)-f(bg)) constraint.
    """
    rng = np.random.default_rng(seed)
    F = x.shape[0]
    bg = background.mean(axis=0)

    sizes = np.arange(1, F)
    size_w = (F - 1) / (sizes * (F - sizes))
    size_p = size_w / size_w.sum()
    ns = rng.choice(sizes, size=num_samples, p=size_p)
    Zmask = np.zeros((num_samples, F), dtype=np.float64)
    for i, s in enumerate(ns):
        Zmask[i, rng.choice(F, size=s, replace=False)] = 1.0

    X = np.where(Zmask > 0, x[None], bg[None]).astype(np.float32)
    y = predict_probs(X)[:, class_idx].astype(np.float64)
    f_x = float(predict_probs(x[None].astype(np.float32))[0, class_idx])
    f_bg = float(predict_probs(bg[None].astype(np.float32))[0, class_idx])

    k = Zmask.sum(axis=1)
    w = (F - 1) / (np.maximum(k, 1) * np.maximum(F - k, 1))

    # constrained WLS: solve for phi with sum(phi) = f_x - f_bg
    A = Zmask.T @ (w[:, None] * Zmask)
    b = Zmask.T @ (w * (y - f_bg))
    ones = np.ones((F, 1))
    KKT = np.block([[A + 1e-8 * np.eye(F), ones], [ones.T, np.zeros((1, 1))]])
    rhs = np.concatenate([b, [f_x - f_bg]])
    sol = np.linalg.solve(KKT, rhs)
    return sol[:F]


def permutation_importance(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    X: np.ndarray,
    labels: np.ndarray,
    metric: str = "accuracy",
    seed: int = 0,
) -> np.ndarray:
    """Global per-feature importance: metric drop when a column is shuffled."""
    from skinjax_torch.train.metrics import classification_metrics

    rng = np.random.default_rng(seed)
    base = classification_metrics(
        labels, predict_probs(X).argmax(1), predict_probs(X)
    )[metric if metric != "accuracy" else "accuracy"]
    out = np.zeros(X.shape[1])
    for f in range(X.shape[1]):
        Xp = X.copy()
        Xp[:, f] = Xp[rng.permutation(len(Xp)), f]
        probs = predict_probs(Xp)
        m = classification_metrics(labels, probs.argmax(1), probs)
        out[f] = base - m[metric if metric != "accuracy" else "accuracy"]
    return out
