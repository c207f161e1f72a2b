"""The port's XAI app and XAI CLI against skinjax's, on the CPU.

The app (``serve/xai_app.py``) and skinjax's ``make_xai_handler`` serve the
same weights (a narrow ResNet tower, RG-ATT, drawn on skinjax's tree and
carried across by ``state_dict_from_flax``) over HTTP: the form, then a POST
of a PNG with one metadata group switched off, whose prediction is skinjax's
(probabilities within 1.5e-3, the page's three decimals) and whose overlay is
skinjax's within 8 levels, 0.5 on average, and more than 2 levels off on
under 1% of the values: the port resizes the upload as its engine does,
within one level of skinjax's OpenCV resize, and that moves the CAM by
~1e-2 (on the same input the two CAMs agree within 2e-3,
``tests/test_torch_xai.py``); ``run_service`` with ``XAI=1`` serves it.
The CLI (``tools/xai_cli.py``, ``--device cpu``) and skinjax's, on 24 rows of
a PAD-UFES-20-shaped set on disk with the same custom-cnn weights (skinjax's
orbax checkpoint, the port's state_dict): the same missing-data rows (1e-6)
and the same flip rates.
"""

import base64
import json
import os
import re
import threading
import urllib.error
import urllib.request
import uuid
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import skinjax.models.backbones as jax_backbones
import skinjax_torch.models.backbones as port_backbones
from skinjax.data.featurizer import MetadataFeaturizer as JaxFeaturizer
from skinjax.models import MultimodalModel as JaxModel
from skinjax.models.backbones import resnet as jresnet
from skinjax.serve import xai_app as jxai_app
from skinjax.serve.engine import InferenceEngine as JaxEngine
from skinjax.tools import xai_cli as jxai_cli
from skinjax.train.checkpoint import save_params
from skinjax_torch.data import schemas
from skinjax_torch.data.featurizer import MetadataFeaturizer
from skinjax_torch.data.fixtures import pad_ufes20_table, write_csv
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.backbones import resnet
from skinjax_torch.models.weights import load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.serve import png, run_service, xai_app
from skinjax_torch.serve.engine import InferenceEngine
from skinjax_torch.tools import xai_cli
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

TOWER = "xai-app-resnet-test"
RGATT = "att-intramodal+residual+cross-attention-metadados"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(n):
    """A PAD-UFES-20-shaped table with its numerical columns filled (skinjax's
    analyses featurize them as they are)."""
    t = pad_ufes20_table(n, seed=5)
    for c in ("diameter_1", "diameter_2"):
        t[c] = [v or "6.0" for v in t[c]]
    return t


class _Server:
    def __init__(self, handler):
        self.handler = handler
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        if hasattr(self.handler, "worker"):
            self.handler.worker.shutdown(wait=True)


def _request(url, body=None, content_type=None):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": content_type} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _form(image_bytes, fields):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n").encode() + image_bytes
    for k, v in fields.items():
        body += (f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
                 f"{v}").encode()
    return body + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _page(html):
    """(class, [probabilities], overlay (H, W, 3)) of an answer page."""
    cls = re.search(r"<h3>Prediction: (.*?)</h3>", html).group(1)
    probs = [float(p) for p in re.findall(r"<li>[^<]*: ([0-9.]+)</li>", html)]
    b64 = re.search(r'src="data:image/png;base64,([^"]+)"', html).group(1)
    return cls, probs, png.decode_png(base64.b64decode(b64))


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """skinjax's engine and model and the port's, on the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jax_backbones._REGISTRY, TOWER, (
        lambda name=None, dtype=None, common_dim=512: jresnet.ResNet(stage_sizes=(1, 1),
                                                                     width=8), 16))
    mp.setitem(port_backbones._REGISTRY, TOWER, (
        lambda device=None: resnet.ResNet((1, 1), "basic", width=8), 16))
    root = tmp_path_factory.mktemp("xai_app")
    fz_path = str(root / "featurizer.json")
    schemas.prepare_dataset("pad-ufes-20", _csv(root, 30), featurizer_path=fz_path)
    jfz, pfz = JaxFeaturizer.load(fz_path), MetadataFeaturizer.load(fz_path)
    cfg = dict(num_classes=pfz.num_classes, num_heads=4, cnn_model_name=TOWER, common_dim=32,
               text_encoder_dim_output=32, vocab_size=pfz.dim, attention_mechanism=RGATT)
    model = JaxModel(**cfg)
    variables = jax_variables(model, (224, 224), cfg["vocab_size"], seed=3)
    port = load_numpy_state_dict(MultimodalModel(**cfg), state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    engine = InferenceEngine(port, pfz, device="cpu")
    yield (JaxEngine(model, variables, jfz), model, variables), (engine, engine.model)
    mp.undo()


def _csv(root, n):
    path = str(root / "meta.csv")
    write_csv(path, _table(n))
    return path


def test_app_answers_as_skinjax(apps):
    (jengine, jmodel, variables), (engine, model) = apps
    rng = np.random.default_rng(0)
    image = png.encode_png(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8))
    fields = {"age": "63", "gender": "FEMALE", "region": "FACE", "smoke": "True",
              "itch": "False", "diameter_1": "7", "group_demographics": "on",
              "group_history": "on", "group_lesion_geometry": "on"}  # symptoms off
    body, ctype = _form(image, fields)
    pages = []
    with _Server(jxai_app.make_xai_handler(jengine, jmodel, variables)) as jsrv, \
            _Server(xai_app.make_xai_handler(engine, model)) as srv:
        code, form, _ = _request(srv.url)
        assert code == 200 and 'name="group_symptoms"' in form and 'name="age"' in form
        for url in (jsrv.url, srv.url):
            code, page, headers = _request(f"{url}/analyze", body, ctype)
            assert code == 200, page
            pages.append(_page(page))
        assert re.fullmatch(r"forward;dur=[0-9.]+, cam;dur=[0-9.]+, encode;dur=[0-9.]+",
                            headers["Server-Timing"])
        code, page, _ = _request(f"{srv.url}/analyze", *_form(b"<script>", fields))
        assert code == 500 and "<script>" not in page and "&lt;script&gt;" not in page
    (jcls, jprobs, joverlay), (cls, probs, overlay) = pages
    assert cls == jcls and len(probs) == len(jprobs) == engine.model.num_classes
    np.testing.assert_allclose(probs, jprobs, atol=1.5e-3)
    assert overlay.shape == joverlay.shape == (224, 224, 3)
    diff = np.abs(overlay.astype(int) - joverlay.astype(int))
    assert diff.max() <= 8 and diff.mean() < 0.5 and (diff > 2).mean() < 0.01
    assert all(p.requires_grad and p.grad is None for p in model.parameters())


def test_run_service_serves_the_app(monkeypatch):
    """XAI=1: ``main`` hands the engine and its model to ``serve_xai`` on
    HOST and PORT."""
    served = {}
    monkeypatch.setattr(xai_app, "serve_xai",
                        lambda engine, model, host, port: served.update(locals()))
    for k, v in dict(DEVICE="cpu", XAI="1", CNN_MODEL_NAME="resnet-18", COMMON_DIM="32",
                     HOST="127.0.0.1", PORT="7861").items():
        monkeypatch.setenv(k, v)
    run_service.main()
    assert isinstance(served["engine"], InferenceEngine)
    assert served["model"] is served["engine"].model
    assert (served["host"], served["port"]) == ("127.0.0.1", 7861)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """24 rows, 224×224 PNGs (no resize on either side), and the weights of a
    custom-cnn concatenation model as skinjax's checkpoint and the port's."""
    root = tmp_path_factory.mktemp("xai_cli")
    csv = _csv(root, 24)
    names = _table(24)["img_id"]
    os.makedirs(root / "images")
    rng = np.random.default_rng(1)
    for name in names:
        (root / "images" / name).write_bytes(
            png.encode_png(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)))
    prepared = schemas.prepare_dataset("pad-ufes-20", csv)
    model = JaxModel(num_classes=prepared.num_classes, num_heads=4, cnn_model_name="custom-cnn",
                     common_dim=32, vocab_size=prepared.feature_dim,
                     attention_mechanism="concatenation")
    variables = jax_variables(model, (224, 224), prepared.feature_dim, seed=9)
    save_params(str(root / "jax_ckpt"), variables["params"])
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in state_dict_from_flax(variables["params"], {}).items()},
               str(root / "port.pt"))
    return root, csv, str(root / "images")


def _flags(root, csv, images, ckpt, analysis, out):
    return [analysis, "--metadata-csv", csv, "--images-dir", images, "--checkpoint", ckpt,
            "--backbone", "custom-cnn", "--mechanism", "concatenation", "--common-dim", "32",
            "--num-heads", "4", "--rates", "0.0", "0.3", "0.7", "--out", str(root / out)]


def test_cli_outputs_match_skinjax(disk, capsys):
    root, csv, images = disk
    for analysis in ("missing-data", "flip-rate"):
        jxai_cli.main(_flags(root, csv, images, str(root / "jax_ckpt"), analysis, "jax"))
        xai_cli.main(_flags(root, csv, images, str(root / "port.pt"), analysis, "port")
                     + ["--device", "cpu"])
    capsys.readouterr()
    rows = [list(__import__("csv").DictReader(open(root / d / "missing_metadata_experiment.csv")))
            for d in ("port", "jax")]
    assert len(rows[0]) == len(rows[1]) == 3
    for ours, ref in zip(*rows):
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(float(ours[k]), float(ref[k]), atol=1e-6, err_msg=k)
    flips = [json.load(open(root / d / "flip_rates.json")) for d in ("port", "jax")]
    assert flips[0] == flips[1] and "smoke" in flips[0]


def test_cli_needs_its_device(monkeypatch, disk):
    root, csv, images = disk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        xai_cli.main(_flags(root, csv, images, str(root / "port.pt"), "flip-rate", "x"))
