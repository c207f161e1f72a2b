"""The port's train CLI path against the JAX package: the PAD-UFES-20 schema
(stdlib csv + numpy) against skinjax's pandas path on CSVs full of pandas'
quirks, the disk image store against skinjax's OpenCV one, the .env config
and the tracker's files; then ``train_cli.main`` end to end on the CPU on a
small PAD-UFES-20-shaped dataset, and the service serving what it wrote."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from skinjax.configs import load_env_config as jax_load_env_config
from skinjax.data import pipeline as jpipeline
from skinjax.data import schemas as jschemas
from skinjax.tracking import Tracker as JaxTracker
from skinjax_torch.configs import load_config, load_env_config, save_config
from skinjax_torch.data import pipeline, schemas
from skinjax_torch.data.fixtures import (
    PAD20_COLUMNS,
    pad_ufes20_table,
    write_csv,
    write_pad_ufes20_like,
)
from skinjax_torch.serve import png, run_service
from skinjax_torch.tools import train_cli
from skinjax_torch.tracking import Tracker
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

RGATT_MB = "att-intramodal+residual+cross-attention-metadados+metablock"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quirky(variant):
    """A PAD-UFES-20 CSV table with pandas' quirks in it. "gaps": blanks in
    the float and boolean columns, the other missing-value strings, stray
    spaces, numbers with spaces around them and unparsable ones in the
    numerical columns. "complete": fitspatrick all integers (rendered "3",
    not "3.0"), smoke all booleans (a bool column), drink booleans in other
    cases with a blank, patient ids as integers."""
    t = pad_ufes20_table(40, seed=7)
    assert tuple(t) == PAD20_COLUMNS  # the published file's 26 columns, in order
    n = len(t["img_id"])
    if variant == "gaps":
        t["gender"][:5] = ["NA", "None", "NULL", "nan", "N/A"]
        t["region"][3] = " "
        t["background_father"][4] = "NÃO  ENCONTRADO"
        t["diameter_1"][:4] = [" 12 ", "abc", "EMPTY", "1e1"]
        t["age"][6] = ""  # an int column with a blank turns float
        t["diagnostic"][7] = "NEV"
    else:
        t["fitspatrick"] = [str(1 + i % 6) for i in range(n)]
        t["smoke"] = ["True" if i % 3 else "False" for i in range(n)]
        t["drink"] = ["TRUE" if i % 2 else "false" for i in range(n)]
        t["drink"][2] = ""
        t["patient_id"] = [str(100 + i // 3) for i in range(n)]
    return t


@pytest.mark.parametrize("variant", ["gaps", "complete"])
def test_prepare_dataset_matches_skinjax(tmp_path, variant):
    csv_path = str(tmp_path / "metadata.csv")
    write_csv(csv_path, _quirky(variant))
    fz_port, fz_jax = str(tmp_path / "fz_port.json"), str(tmp_path / "fz_jax.json")
    got = schemas.prepare_dataset("pad-ufes-20", csv_path, featurizer_path=fz_port)
    want = jschemas.prepare_dataset("pad-ufes-20", csv_path, featurizer_path=fz_jax)
    assert np.array_equal(got.features, want.features)
    assert got.features.dtype == want.features.dtype
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.groups, want.groups)
    assert got.image_files == want.image_files
    assert got.class_names == want.class_names
    with open(fz_port) as a, open(fz_jax) as b:
        assert a.read() == b.read()
    if variant == "complete":
        assert ["1", "2", "3", "4", "5", "6"] in got.featurizer.ohe.categories
    else:
        assert ["1.0", "2.0", "3.0", "4.0", "5.0", "6.0", "EMPTY"] in got.featurizer.ohe.categories
    # a second read loads the saved featurizer: the same feature space
    again = schemas.prepare_dataset("pad-ufes-20", csv_path, featurizer_path=fz_port)
    assert np.array_equal(again.features, got.features)


def test_other_datasets_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        schemas.prepare_dataset("isic-2019", "metadata.csv")


def test_image_store_matches_skinjax_within_one_level(tmp_path):
    rng = np.random.default_rng(4)
    names = []
    for i, (shape, paeth) in enumerate((((30, 41), True), ((224, 224), False), ((300, 400), True))):
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        names.append(f"img{i}.png")
        (tmp_path / names[-1]).write_bytes(png.encode_png(img, paeth=paeth))
    got = pipeline.ImageStore(str(tmp_path)).gather(names)
    want = jpipeline.ImageStore(str(tmp_path)).gather(names)
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 224, 224, 3)
    # OpenCV resizes uint8 in 11-bit fixed point; the port in fp32 and rounds
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.array_equal(got[1], want[1])  # 224×224 is not resized


def test_image_store_refuses_what_it_cannot_decode(tmp_path):
    ok, jpeg = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "a.jpg").write_bytes(jpeg.tobytes())
    ok, gray = cv2.imencode(".png", np.zeros((8, 8), np.uint8))
    (tmp_path / "b.png").write_bytes(gray.tobytes())
    store = pipeline.ImageStore(str(tmp_path))
    with pytest.raises(pipeline.UnsupportedImage, match="PNG only"):
        store.get("a.jpg")
    with pytest.raises(pipeline.UnsupportedImage):
        store.get("b.png")
    with pytest.raises(FileNotFoundError):
        store.get("missing.png")


def test_env_config_matches_skinjax(tmp_path, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("# reference knobs\nNUM_EPOCHS=7\nBATCH_SIZE='16'\nUNFREEZE_WEIGHTS=False\n"
                   'LIST_NUM_HEADS="[2, 4]"\nCOMMON_DIM=256\nK_FOLDS=3\nsave_to_disk=0\n')
    monkeypatch.setenv("K_FOLDS", "4")  # the process environment wins
    got, want = load_env_config(str(env)), jax_load_env_config(str(env))
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    gt, wt = g.pop("train"), w.pop("train")
    assert g == w and g["k_folds"] == 4 and g["list_num_heads"] == [2, 4]
    assert {k: gt[k] for k in wt if k in gt} == {k: wt[k] for k in wt if k in gt}
    assert gt["unfreeze_weights"] == "frozen_weights" and gt["device"] == "cuda"
    save_config(got, str(tmp_path / "cfg.json"))
    assert load_config(str(tmp_path / "cfg.json")) == got


def test_tracker_files_match_skinjax(tmp_path, monkeypatch):
    import skinjax.tracking as jt

    import skinjax_torch.tracking as pt

    for mod in (jt, pt):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
        monkeypatch.setattr(mod.uuid, "uuid4", lambda: type("U", (), {"hex": "abcdef0123"})())
    monkeypatch.setattr(jt, "_mlflow", None)
    trees = []
    for cls, root in ((Tracker, tmp_path / "port"), (JaxTracker, tmp_path / "jax")):
        tr = cls(root=str(root))
        tr.set_experiment("exp")
        with tr.start_run("fold_1"):
            tr.log_param("fold_num", 1)
            tr.log_dict({"val_loss": 0.5, "epoch": 2, "note": "x"}, step=3)
            tr.log_metric("bacc", 0.75)
        trees.append({os.path.relpath(os.path.join(d, f), root): (Path(d) / f).read_text()
                      for d, _, fs in os.walk(root) for f in fs})
    assert trees[0] == trees[1]
    assert set(trees[0]) == {f"exp/fold_1-abcdef01/{f}"
                             for f in ("run.json", "params.json", "metrics.jsonl")}


def test_cli_path_imports_no_jax_pandas_or_opencv():
    """The card's machine has neither pandas nor OpenCV."""
    code = (
        "import sys\n"
        "import skinjax_torch.tools.train_cli, skinjax_torch.train.experiments\n"
        "import skinjax_torch.configs, skinjax_torch.tracking, skinjax_torch.data.schemas\n"
        "import skinjax_torch.data.fixtures, skinjax_torch.models.factory\n"
        "banned = ('jax', 'jaxlib', 'flax', 'skinjax', 'pandas', 'cv2', 'matplotlib')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cli_refuses_what_it_cannot_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--synthetic"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_cli.main(["--synthetic", "--mesh-data", "2", "--device", "cpu"])


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """train_cli.main on 24 PNGs of a PAD-UFES-20-shaped dataset: one
    mechanism (…+metablock), ResNet-18, two folds, one epoch, on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    csv_path, images = write_pad_ufes20_like(str(root / "data"), n=24, image_hw=(30, 40))
    results = str(root / "results")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        metrics = train_cli.main([
            "--dataset", "pad-ufes-20", "--metadata-csv", csv_path, "--images-dir", images,
            "--results-dir", results, "--mechanisms", RGATT_MB, "--backbones", "resnet-18",
            "--k-folds", "2", "--epochs", "1", "--batch-size", "8", "--device", "cpu",
        ])
    finally:
        torch.set_num_threads(n)
    return csv_path, results, metrics


def test_train_cli_runs_every_fold_and_writes_its_artifacts(cli_run):
    _, results, metrics = cli_run
    assert len(metrics) == 1 * 1 * 1 * 2  # mechanisms × backbones × heads × folds
    assert [m["fold"] for m in metrics] == [1, 2]
    assert all(np.isfinite(m["balanced_accuracy"]) and np.isfinite(m["auc"]) for m in metrics)
    cell = os.path.join(results, f"multimodal_resnet-18_{RGATT_MB}_h8")
    with open(os.path.join(cell, "model_metrics.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 2
    fz = json.loads(Path(results, "preprocess_data", "featurizer_pad-ufes-20.json").read_text())
    assert fz["classes"] == ["ACK", "BCC", "MEL", "NEV", "SCC", "SEK"]
    for k in (1, 2):
        fold = os.path.join(cell, f"multimodal_resnet-18_{RGATT_MB}_h8_fold_{k}")
        assert os.path.isfile(os.path.join(fold, "best", "state.pt"))
        assert os.path.isfile(os.path.join(fold, f"predictions_eval_fold_{k}.csv"))
    runs = os.listdir(os.path.join(results, "tracking", "skinjax-pad-ufes-20"))
    assert len(runs) == 2


@pytest.mark.parametrize("form", ["directory", "state.pt", "state_dict"])
def test_service_serves_the_trained_checkpoint(cli_run, monkeypatch, tmp_path, form):
    csv_path, results, _ = cli_run
    cell = os.path.join(results, f"multimodal_resnet-18_{RGATT_MB}_h8")
    best = os.path.join(cell, f"multimodal_resnet-18_{RGATT_MB}_h8_fold_1", "best")
    saved = torch.load(os.path.join(best, "state.pt"), weights_only=True)["model"]
    ckpt = {"directory": best, "state.pt": os.path.join(best, "state.pt"),
            "state_dict": str(tmp_path / "weights.pt")}[form]
    if form == "state_dict":
        torch.save(saved, ckpt)
    fz_path = os.path.join(results, "preprocess_data", "featurizer_pad-ufes-20.json")
    for k, v in dict(DEVICE="cpu", MODEL_CHECKPOINT=ckpt, FEATURIZER_JSON=fz_path,
                     CNN_MODEL_NAME="resnet-18", ATTENTION_MECHANISM=RGATT_MB).items():
        monkeypatch.setenv(k, v)
    engine = run_service.build_engine()
    assert engine.fused
    live = engine.model.state_dict()
    assert set(live) == set(saved)
    assert all(torch.equal(live[k].cpu(), saved[k]) for k in saved)  # BatchNorm buffers too
    if form != "directory":
        return
    table = pad_ufes20_table(24, seed=0)
    cols = engine.featurizer.categorical_cols + engine.featurizer.numerical_cols
    line = ", ".join(table[c][0] for c in cols)
    img = png.decode_png(Path(csv_path).parent.joinpath("images", table["img_id"][0])
                         .read_bytes())
    out = engine.predict(img, line)
    assert out["predicted_classname"] in engine.class_names
    assert abs(sum(out["probabilities"]) - 1.0) < 1e-5
