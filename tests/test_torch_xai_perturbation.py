"""The port's perturbation analyses, tabular explainers and reports against
skinjax's, on PAD-UFES-20-shaped tables read by each package's own
``prepare_dataset`` (skinjax's a DataFrame, the port's a column dict).

Both sides get one shared numpy ``predict_probs`` (a fixed softmax-linear
map of the features), so every number has to come out equal: the missing
cells bit for bit, the flip analysis, uncertainty, FDS and missing-data rows,
LIME, KernelSHAP and permutation importance at the same seed exactly.
"""

import numpy as np
import pytest

from skinjax.data import schemas as jschemas
from skinjax.xai import perturbation as jpert
from skinjax.xai import reports as jreports
from skinjax.xai import tabular as jtab
from skinjax_torch.data import schemas
from skinjax_torch.data.fixtures import pad_ufes20_table, write_csv
from skinjax_torch.xai import perturbation as pert
from skinjax_torch.xai import reports, tabular

RATES = (0.0, 0.1, 0.3, 0.7)


def _prepared(tmp_path, blanks: bool):
    """(skinjax's prepared set, the port's) from one CSV; ``blanks=False``
    fills the numerical columns, which skinjax's analyses need."""
    t = pad_ufes20_table(48, seed=11)
    t["gender"][:3] = ["NA", " ", "MALE"]
    if blanks:
        t["diameter_1"][:4] = [" 12 ", "abc", "", "1e1"]
    else:
        for c in ("diameter_1", "diameter_2"):
            t[c] = [v or "7.5" for v in t[c]]
    path = str(tmp_path / "meta.csv")
    write_csv(path, t)
    return (jschemas.prepare_dataset("pad-ufes-20", path),
            schemas.prepare_dataset("pad-ufes-20", path))


def _predictor(dim, k=6, seed=0):
    rng = np.random.default_rng(seed)
    w, b = rng.normal(size=(dim, k)), rng.normal(size=k)

    def predict(x):
        z = np.asarray(x, np.float64) @ w + b
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    return predict


@pytest.mark.parametrize("rate", RATES)
def test_missing_cells_match_skinjax(tmp_path, rate):
    """simulate_missing_metadata on the table with blanks: every column the
    same cells as skinjax's DataFrame, numbers as float64 bit for bit."""
    jp, pp = _prepared(tmp_path, blanks=True)
    fz = pp.featurizer
    for fold in (1, 3):
        seed = int(fold + rate * 1000)
        ref = jpert.simulate_missing_metadata(jp.raw, rate, seed, fz.categorical_cols,
                                              fz.numerical_cols)
        out = pert.simulate_missing_metadata(pp.raw, rate, seed, fz.categorical_cols,
                                             fz.numerical_cols)
        assert list(out) == list(ref.columns)
        for c in fz.numerical_cols if rate > 0 else ():
            assert out[c].dtype == np.float64
            np.testing.assert_array_equal(out[c], ref[c].to_numpy())
        for c in out:
            assert [str(v) for v in out[c]] == [str(v) for v in ref[c].to_numpy()], c


def test_analyses_match_skinjax(tmp_path):
    """run_flip_analysis (every intervention's flip rate, flips, transition
    matrix and probabilities), prediction_uncertainty, FDS and the
    missing-data sweep's rows: skinjax's numbers, exactly."""
    jp, pp = _prepared(tmp_path, blanks=False)
    np.testing.assert_array_equal(pert.featurize(pp.featurizer, pp.raw),
                                  jpert._featurize(jp.featurizer, jp.raw))
    predict = _predictor(pp.feature_dim)
    ref = jpert.run_flip_analysis(predict, jp.raw, jp.featurizer)
    out = pert.run_flip_analysis(predict, pp.raw, pp.featurizer)
    np.testing.assert_array_equal(out["base_probs"], ref["base_probs"])
    assert list(out["mutations"]) == list(ref["mutations"])
    for name, r in ref["mutations"].items():
        o = out["mutations"][name]
        assert (o["flip_rate"], o["n_flips"], o["description"]) == (
            r["flip_rate"], r["n_flips"], r["description"]), name
        np.testing.assert_array_equal(o["transition_matrix"], r["transition_matrix"])
        np.testing.assert_array_equal(o["probs"], r["probs"])
        assert pert.prediction_uncertainty(out["base_probs"], o["probs"]) == \
            jpert.prediction_uncertainty(ref["base_probs"], r["probs"])
        assert pert.faithfulness_degradation_score(out["base_probs"], o["probs"]) == \
            jpert.faithfulness_degradation_score(ref["base_probs"], r["probs"])
    assert any(r["n_flips"] for r in ref["mutations"].values())
    assert reports.per_feature_uncertainty(out) == jreports.per_feature_uncertainty(ref)
    for fold in (1, 2):
        rows = pert.missing_data_sweep(predict, pp.raw, pp.featurizer, pp.labels, fold, RATES)
        assert rows == jpert.missing_data_sweep(predict, jp.raw, jp.featurizer, jp.labels,
                                                fold, RATES)


def test_featurize_takes_blank_numbers(tmp_path):
    """A blank diameter ("EMPTY" in the cleaned table) featurizes as -1, as
    ``prepare_dataset`` featurizes it; skinjax's analyses raise there."""
    jp, pp = _prepared(tmp_path, blanks=True)
    np.testing.assert_array_equal(pert.featurize(pp.featurizer, pp.raw), pp.features)
    with pytest.raises(ValueError):
        jpert._featurize(jp.featurizer, jp.raw)
    out = pert.run_flip_analysis(_predictor(pp.feature_dim), pp.raw, pp.featurizer)
    assert {"diameter_1", "smoke", "region"} <= set(out["mutations"])


def test_tabular_explainers_match_skinjax():
    """LIME (continuous, categorical), KernelSHAP and permutation importance
    at the same seed and predictor: skinjax's numbers, exactly."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 9)).astype(np.float32)
    X[:, :3] = rng.integers(0, 3, (64, 3))
    labels = rng.integers(0, 6, 64)
    predict = _predictor(9, seed=3)
    x = X[5].astype(np.float64)
    for fn, args in ((tabular.lime_tabular, (predict, x, 2)),
                     (tabular.lime_tabular_categorical, (predict, x, 2, X, [0, 1, 2])),
                     (tabular.kernel_shap, (predict, x, X, 4)),
                     (tabular.permutation_importance, (predict, X, labels))):
        ref = getattr(jtab, fn.__name__)(*args, seed=7)
        np.testing.assert_array_equal(fn(*args, seed=7), ref, err_msg=fn.__name__)


def test_plots_need_matplotlib_only_to_draw(tmp_path, monkeypatch, capsys):
    """The three plots write their PNGs; without matplotlib they write
    nothing and say so."""
    res = pert.run_flip_analysis(_predictor(5), {"smoke": np.array(["True", "False"] * 4)},
                                 _featurizer_of(["smoke"]))
    rows = {"a": [{"missing_rate": r, "balanced_accuracy": 1 - r} for r in RATES]}
    draws = [lambda p: reports.flip_rate_barplot(res, p),
             lambda p: reports.transition_heatmap(res, "smoke", list("ABCDEF"), p),
             lambda p: reports.degradation_comparison_plot(rows, p)]
    for i, draw in enumerate(draws):
        draw(str(tmp_path / f"{i}.png"))
        assert (tmp_path / f"{i}.png").stat().st_size > 0
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    for i, draw in enumerate(draws):
        draw(str(tmp_path / f"none{i}.png"))
        assert not (tmp_path / f"none{i}.png").exists()
    assert capsys.readouterr().out.count("matplotlib is not installed") == 3


def _featurizer_of(cols):
    from skinjax_torch.data.featurizer import MetadataFeaturizer

    fz = MetadataFeaturizer(categorical_cols=cols, numerical_cols=[])
    return fz.fit({c: np.array(["True", "False", "x", "y", "z"]) for c in cols},
                  list("ABCDEF"))
