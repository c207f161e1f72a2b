"""The port's fold loop: the vendored numpy modules give skinjax's arrays,
train_process trains and resumes exactly on the CPU, early stopping and the
plateau schedule follow skinjax's, and run_kfold writes its artifacts."""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from skinjax.data import pipeline as jpipe
from skinjax.data import sampling as jsamp
from skinjax.data import splits as jsplits
from skinjax.train import metrics as jmetrics
from skinjax.train.early_stopping import EarlyStopping as JaxEarlyStopping
from skinjax.train.optimizer import PlateauScheduler as JaxPlateau
from skinjax_torch.data import pipeline, sampling, splits
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.weights import init_weights
from skinjax_torch.train import metrics
from skinjax_torch.train.early_stopping import EarlyStopping
from skinjax_torch.train.kfold import run_kfold
from skinjax_torch.train.loop import TrainConfig, train_process
from skinjax_torch.train.optimizer import PlateauScheduler
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

CFG = dict(num_classes=3, num_heads=4, cnn_model_name="resnet-18", common_dim=16,
           text_encoder_dim_output=16, vocab_size=7,
           attention_mechanism="att-intramodal+residual+cross-attention-metadados")
CLASSES = ["ACK", "BCC", "MEL"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes,
    and PyTorch's default of a thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return init_weights(MultimodalModel(**CFG), seed=0)


def _source(n=40):
    return pipeline.synthetic_source(n=n, image_size=(16, 16), feature_dim=7, num_classes=3,
                                     seed=1)


def _config(**kw):
    return TrainConfig(**{**dict(num_epochs=2, batch_size=8, device="cpu"), **kw})


# ---------------------------------------------------------------------------
# the vendored numpy modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_epoch_batches_equal_skinjax(weighted, drop_remainder):
    labels = np.random.default_rng(0).integers(0, 6, 103)
    for seed, epoch in ((42, 0), (42, 3), (7, 1)):
        a = sampling.epoch_batches(labels, 6, 16, seed, epoch, weighted, drop_remainder)
        b = jsamp.epoch_batches(labels, 6, 16, seed, epoch, weighted, drop_remainder)
        np.testing.assert_array_equal(a, b)


def test_class_weights_and_resampling_equal_skinjax():
    labels = np.random.default_rng(1).integers(0, 5, 200)
    labels[labels == 3] = 4  # an absent class gets weight 0
    np.testing.assert_array_equal(sampling.compute_class_weights(labels, 6),
                                  jsamp.compute_class_weights(labels, 6))
    np.testing.assert_array_equal(sampling.weighted_sample_indices(labels, 6, 50, 3, 2),
                                  jsamp.weighted_sample_indices(labels, 6, 50, 3, 2))


def test_splits_equal_skinjax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 4, 120)
    groups = rng.integers(0, 37, 120)
    for ours, ref in ((splits.stratified_kfold(labels, 5, seed=42),
                       jsplits.stratified_kfold(labels, 5, seed=42)),
                      (splits.stratified_group_kfold(labels, groups, 5, seed=42),
                       jsplits.stratified_group_kfold(labels, groups, 5, seed=42))):
        for (tr, va), (jtr, jva) in zip(ours, ref, strict=True):
            np.testing.assert_array_equal(tr, jtr)
            np.testing.assert_array_equal(va, jva)
    for a, b in zip(splits.train_val_split(labels, 0.2, 42), jsplits.train_val_split(labels, 0.2, 42)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_source_and_metrics_equal_skinjax():
    a = pipeline.synthetic_source(n=12, image_size=(8, 8), feature_dim=5, num_classes=3, seed=4)
    b = jpipe.synthetic_source(n=12, image_size=(8, 8), feature_dim=5, num_classes=3, seed=4)
    for k in ("images", "features", "labels"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    rng = np.random.default_rng(5)
    y = rng.integers(0, 4, 60)
    probs = rng.dirichlet(np.ones(4), 60)
    pred = probs.argmax(1)
    assert metrics.classification_metrics(y, pred, probs, 4, fold=2) == \
        jmetrics.classification_metrics(y, pred, probs, 4, fold=2)


def test_prefetch_batches_in_order():
    src = _source(24)
    idx = np.arange(24).reshape(3, 8)[::-1]
    out = list(pipeline.prefetch_batches(src, idx, prefetch=2))
    assert [b["label"].tolist() for b in out] == [src.labels[r].tolist() for r in idx]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_train_process_two_epochs():
    src = _source()
    state, m, hist = train_process(_model(), src, src, 3, _config())
    assert len(hist["train_loss"]) == len(hist["val_loss"]) == 2
    assert all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    assert hist["probabilities"].shape == (40, 3)
    np.testing.assert_allclose(hist["probabilities"].sum(1), 1.0, atol=1e-5)
    assert m["fold"] == 0 and m["epochs"] == 1 and 0.0 <= m["balanced_accuracy"] <= 1.0
    assert state.step <= 2 * (40 // 8) and next(state.model.parameters()).device.type == "cpu"


def test_train_process_refuses_missing_cuda_and_a_mesh():
    src = _source(8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_process(_model(), src, src, 3, TrainConfig(num_epochs=1))
    with pytest.raises(NotImplementedError, match="mesh"):
        train_process(_model(), src, src, 3, _config(), mesh=object())


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Epoch 1 from a checkpoint gives the same history, predictions and
    weights as the run that never stopped."""
    src = _source()
    cfg = _config(num_epochs=2, augment=True, image_dtype="float32")
    full_state, _, full = train_process(_model(), src, src, 3, cfg)

    resume = str(tmp_path / "resume")
    train_process(_model(), src, src, 3, _config(num_epochs=1, augment=True,
                                                 image_dtype="float32"), resume_dir=resume)
    assert sorted(os.listdir(resume)) == ["best", "latest", "progress.json"]
    state, _, resumed = train_process(_model(), src, src, 3, cfg, resume_dir=resume)
    assert resumed["train_loss"] == full["train_loss"]
    assert resumed["val_loss"] == full["val_loss"]
    np.testing.assert_array_equal(resumed["probabilities"], full["probabilities"])
    assert state.step == full_state.step
    for (k, a), b in zip(state.model.state_dict().items(), full_state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_early_stopping_and_plateau_follow_skinjax():
    val = [1.0, 0.9, 0.905, 0.91, 0.899, 0.95, 0.97, 0.96, 0.2, 0.3, 0.31, 0.32, 0.33]
    for metric in ("val_loss", "val_bacc"):
        ours, ref = (E(patience=3, delta=0.01, metric_name=metric)
                     for E in (EarlyStopping, JaxEarlyStopping))
        pl, jpl = PlateauScheduler(lr=1e-3, patience=1), JaxPlateau(lr=1e-3, patience=1)
        for epoch, v in enumerate(val):
            got = ours(val_loss=v, val_bacc=1 - v, state=lambda e=epoch: e)
            want = ref(val_loss=v, val_bacc=1 - v, state=lambda e=epoch: e)
            assert got == want
            assert (ours.counter, ours.best_score, ours.early_stop, ours.best_state) == \
                (ref.counter, ref.best_score, ref.early_stop, ref.best_state)
            assert pl.step(v) == jpl.step(v)
            assert (pl.best, pl.num_bad) == (jpl.best, jpl.num_bad)
    with pytest.raises(ValueError):
        EarlyStopping(metric_name="auc")


@pytest.mark.parametrize("plots", [True, False])
def test_run_kfold_writes_its_artifacts(tmp_path, monkeypatch, capsys, plots):
    if not plots:  # without matplotlib the CSVs and arrays are still written
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    src = _source(30)
    groups = np.arange(30) // 2
    out = run_kfold(_model, src, src.labels, groups, 3, CLASSES, _config(num_epochs=1),
                    k_folds=2, results_dir=str(tmp_path), model_name="m",
                    save_checkpoints=True)
    assert len(out) == 2
    with open(tmp_path / "model_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["fold"] for r in rows] == ["1", "2"] and rows[0]["model"] == "m"
    for fold in (1, 2):
        d = tmp_path / f"m_fold_{fold}"
        names = set(os.listdir(d))
        assert {"labels.npy", "predictions.npy", "probabilities.npy", "targets.npy",
                f"predictions_eval_fold_{fold}.csv", "best"} <= names
        pngs = {"confusion_matrix.png", "roc.png", "loss_curves.png"}
        assert pngs <= names if plots else not pngs & names
        with open(d / f"predictions_eval_fold_{fold}.csv") as f:
            assert next(csv.reader(f)) == ["image_name", "label", "prediction",
                                           "prob_ACK", "prob_BCC", "prob_MEL"]
    assert ("matplotlib is not installed" in capsys.readouterr().out) == (not plots)
