"""Metadata perturbation analyses: flip rate, prediction uncertainty, FDS and
the missing-data robustness sweep (counterpart of
``skinjax/xai/perturbation.py``), without pandas.

The table is the port's column dict (``PreparedDataset.raw``: column name →
numpy array, as ``Series.to_numpy()`` gives it), and every analysis runs
against a ``predict_probs(features) -> probs`` callable with the images
fixed (the CLI's batched ``InferenceEngine.predict_probs``). Where skinjax
goes through pandas, the same values come out:

  ``pd.to_numeric(s, errors="coerce").fillna(-1)``  ``to_numeric``: numbers
      as they are, strings parsed as pandas parses them, the rest -1
  ``s.astype(object)``  the column as Python objects, so a masked cell can
      take the string "EMPTY"

``featurize`` coerces the numerical columns (skinjax raises on a blank
one). ``simulate_missing_metadata`` draws as skinjax does: one
``default_rng(seed).random(n)`` per column, in ``categorical_cols +
numerical_cols`` order, none for a column the table lacks or at a rate of 0
or below, so its masks are skinjax's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from skinjax_torch.data import schemas
from skinjax_torch.data.featurizer import MetadataFeaturizer

Table = Dict[str, np.ndarray]
EMPTY = schemas.EMPTY


def to_numeric(col: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(col, errors="coerce").fillna(-1)`` as float64."""
    out = schemas.to_numeric(list(col))
    out[np.isnan(out)] = -1.0
    return out


def _map(col: np.ndarray, swap: Dict[str, str]) -> np.ndarray:
    """``Series.map``: a cell whose ``str`` is a key becomes its value; any
    other cell stays as it is."""
    return np.asarray([swap.get(str(v), v) for v in col], dtype=object)


# ---------------------------------------------------------------------------
# mutations (the reference's flip_rate.py:164-183)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mutation:
    """One metadata intervention: a column and its transform, a numpy column
    to a numpy column of the same length."""

    feature: str
    transform: Callable[[np.ndarray], np.ndarray]
    description: str = ""


BOOLEAN_COLUMNS = ("smoke", "drink", "pesticide", "skin_cancer_history", "cancer_history",
                   "has_piped_water", "has_sanitation", "itch", "grew", "hurt", "changed",
                   "bleed", "elevation", "biopsed")


def default_pad20_mutations() -> List[Mutation]:
    """The reference's interventions: booleans flip, age → 80, diameters
    + 5, gender swap, region → FACE."""
    muts = [Mutation(b, lambda s: _map(s, {"True": "False", "False": "True"}), "bool flip")
            for b in BOOLEAN_COLUMNS]
    muts.append(Mutation("age", lambda s: np.full(len(s), 80.0), "age->80"))
    for d in ("diameter_1", "diameter_2"):
        muts.append(Mutation(d, lambda s: to_numeric(s) + 5, "+5mm"))
    muts.append(Mutation("gender", lambda s: _map(s, {"FEMALE": "MALE", "MALE": "FEMALE"}),
                         "gender swap"))
    muts.append(Mutation("region", lambda s: np.full(len(s), "FACE", dtype=object),
                         "region->FACE"))
    return muts


def featurize(fz: MetadataFeaturizer, table: Table) -> np.ndarray:
    """The featurizer on the table's feature columns, the numerical ones
    through ``to_numeric`` as ``prepare_dataset`` featurizes them. skinjax
    hands them over as they are, which is the same where they hold numbers
    only, and raises where one holds a blank ("EMPTY", as PAD-UFES-20's
    diameters do)."""
    cols = {c: table[c] for c in fz.categorical_cols}
    cols.update({c: to_numeric(table[c]) for c in fz.numerical_cols})
    return fz.transform(cols)


def _rows(table: Table) -> int:
    return len(next(iter(table.values())))


def run_flip_analysis(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    raw: Table,
    featurizer: MetadataFeaturizer,
    mutations: Optional[Sequence[Mutation]] = None,
    num_classes: Optional[int] = None,
) -> Dict:
    """For each mutation of a column the table has: inference again, the
    flip rate and the K×K transition matrix of the predictions."""
    mutations = [m for m in (mutations or default_pad20_mutations()) if m.feature in raw]
    base_probs = predict_probs(featurize(featurizer, raw))
    base_pred = base_probs.argmax(axis=1)
    K = num_classes or base_probs.shape[1]
    results = {}
    for m in mutations:
        mutated = dict(raw)
        mutated[m.feature] = np.asarray(m.transform(raw[m.feature]))
        probs = predict_probs(featurize(featurizer, mutated))
        pred = probs.argmax(axis=1)
        flips = pred != base_pred
        trans = np.zeros((K, K), dtype=np.int64)
        np.add.at(trans, (base_pred, pred), 1)
        results[m.feature] = {
            "flip_rate": float(flips.mean()),
            "n_flips": int(flips.sum()),
            "transition_matrix": trans,
            "probs": probs,
            "description": m.description,
        }
    return {"base_probs": base_probs, "base_pred": base_pred, "mutations": results}


# ---------------------------------------------------------------------------
# uncertainty (analyze_prediction_uncertainty.py:166-193)
# ---------------------------------------------------------------------------


def entropy(p: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    p = np.clip(p, eps, 1.0)
    return -(p * np.log(p)).sum(axis=-1)


def kl_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    p = np.clip(p, eps, 1.0)
    q = np.clip(q, eps, 1.0)
    return (p * (np.log(p) - np.log(q))).sum(axis=-1)


def js_divergence(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    m = 0.5 * (p + q)
    return 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)


def prediction_uncertainty(base_probs: np.ndarray, ablated_probs: np.ndarray) -> Dict:
    return {
        "entropy_base": float(entropy(base_probs).mean()),
        "entropy_ablated": float(entropy(ablated_probs).mean()),
        "kl": float(kl_divergence(base_probs, ablated_probs).mean()),
        "js": float(js_divergence(base_probs, ablated_probs).mean()),
    }


# ---------------------------------------------------------------------------
# FDS (generate_fds_analysis.py:16-47)
# ---------------------------------------------------------------------------


def faithfulness_degradation_score(base_probs: np.ndarray, ablated_probs: np.ndarray) -> float:
    """FDS = 0.45·JS/ln(K) + 0.35·Δconf + 0.20·flip rate (Δconf: the drop of
    the base class's probability, clipped to [0, 1])."""
    K = base_probs.shape[1]
    js = js_divergence(base_probs, ablated_probs).mean() / np.log(K)
    base_conf = base_probs.max(axis=1)
    abl_conf = np.take_along_axis(ablated_probs, base_probs.argmax(axis=1)[:, None], axis=1)[:, 0]
    dconf = np.clip(base_conf - abl_conf, 0.0, 1.0).mean()
    flip = (base_probs.argmax(1) != ablated_probs.argmax(1)).mean()
    return float(0.45 * js + 0.35 * dconf + 0.20 * flip)


# ---------------------------------------------------------------------------
# missing-data robustness (inference_all_folds.py:116-129)
# ---------------------------------------------------------------------------


def simulate_missing_metadata(
    raw: Table,
    missing_rate: float,
    seed: int,
    categorical_cols: Sequence[str],
    numerical_cols: Sequence[str],
) -> Table:
    """A copy of the table with a seeded share of its feature cells missing:
    numeric → -1.0 (the column through ``to_numeric``), categorical →
    "EMPTY" (the column as objects)."""
    out = dict(raw)
    rng = np.random.default_rng(seed)
    n = _rows(raw)
    for col in list(categorical_cols) + list(numerical_cols):
        if col not in out or missing_rate <= 0:
            continue
        mask = rng.random(n) < missing_rate
        if col in numerical_cols:
            vals = to_numeric(out[col])
            vals[mask] = -1.0
        else:
            vals = np.asarray(out[col]).astype(object)
            vals[mask] = EMPTY
        out[col] = vals
    return out


def missing_data_sweep(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    raw: Table,
    featurizer: MetadataFeaturizer,
    labels: np.ndarray,
    fold: int = 1,
    rates: Sequence[float] = (0.0, 0.1, 0.2, 0.3, 0.5, 0.7),
) -> List[Dict]:
    """Accuracy, balanced accuracy, F1 and AUC a missing rate, seeded
    ``int(fold + rate·1000)`` (the rows of missing_metadata_experiment.csv)."""
    from skinjax_torch.train.metrics import classification_metrics

    rows = []
    for rate in rates:
        seed = int(fold + rate * 1000)
        mutated = simulate_missing_metadata(raw, rate, seed, featurizer.categorical_cols,
                                            featurizer.numerical_cols)
        probs = predict_probs(featurize(featurizer, mutated))
        m = classification_metrics(labels, probs.argmax(1), probs)
        rows.append({"fold": fold, "missing_rate": rate, **m})
    return rows
