"""The port's serving surface: the HTTP API against the JAX server, the PNG
codec and the on-device resize against OpenCV, the service's refusal to run
without its device, and the port's independence from JAX."""

import base64
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import uuid
import zlib
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from skinjax.data.featurizer import MetadataFeaturizer as JaxFeaturizer
from skinjax.models import MultimodalModel as JaxModel
from skinjax.serve.api import make_handler as jax_handler
from skinjax.serve.engine import InferenceEngine as JaxEngine
from skinjax_torch.data.featurizer import MetadataFeaturizer
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.weights import init_weights, load_numpy_state_dict, state_dict_from_flax
from skinjax_torch.serve import png, run_service
from skinjax_torch.serve.api import make_handler
from skinjax_torch.serve.batching import BatchingEngine
from skinjax_torch.serve.engine import InferenceEngine, resize_u8
from tests.test_torch_weights import jax_variables
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_classes=4, num_heads=4, cnn_model_name="resnet-18", common_dim=32,
           text_encoder_dim_output=32, vocab_size=7,
           attention_mechanism="att-intramodal+residual+cross-attention-metadados")


def _featurizer(cls):
    """The featurizer of tests/test_serving.py, saved and loaded as JSON."""
    fz = cls(categorical_cols=["region", "itch"], numerical_cols=["age"])
    fz.ohe.categories = [["ARM", "FACE", "NECK"], ["False", "True", "EMPTY"]]
    fz.scaler.mean = np.array([50.0])
    fz.scaler.scale = np.array([20.0])
    fz.label_encoder.classes = ["ACK", "BCC", "MEL", "NEV"]
    return fz


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
        assert not self.thread.is_alive()
        if hasattr(self.handler, "worker"):  # the port's inference thread
            self.handler.worker.shutdown(wait=True)


def _post(url, body, content_type):
    req = urllib.request.Request(f"{url}/predict/", data=body,
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _multipart(image_bytes, metadata):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
    body += image_bytes + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"metadata\"\r\n\r\n"
        f"{metadata}\r\n--{boundary}--\r\n").encode()
    return body, f"multipart/form-data; boundary={boundary}"


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fz") / "featurizer.json")
    _featurizer(JaxFeaturizer).save(path)
    jfz, tfz = JaxFeaturizer.load(path), MetadataFeaturizer.load(path)
    model = JaxModel(**CFG)
    variables = jax_variables(model, (224, 224), CFG["vocab_size"], seed=11)
    port = load_numpy_state_dict(
        MultimodalModel(**CFG),
        state_dict_from_flax(variables["params"], variables["batch_stats"]))
    return (JaxEngine(model, variables, jfz, use_fused=True),
            InferenceEngine(port, tfz, use_fused=True, device="cpu"))


def test_predict_json_matches_the_jax_server(engines):
    jax_engine, port_engine = engines
    # 224×224: neither server resizes, so both see the same pixels
    img = np.random.default_rng(2).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    body, ctype = _multipart(buf.tobytes(), "FACE, True, 63")
    with _Server(jax_handler(jax_engine)) as js, _Server(make_handler(port_engine)) as ts:
        jcode, jout = _post(js.url, body, ctype)
        tcode, tout = _post(ts.url, body, ctype)
        jcode_b64, tout_b64 = _post(ts.url, json.dumps({
            "image_b64": base64.b64encode(png.encode_png(img)).decode(),
            "metadata": "FACE, True, 63"}).encode(), "application/json")
        with urllib.request.urlopen(f"{ts.url}/health", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    assert jcode == tcode == jcode_b64 == 200
    assert set(tout) == set(jout) == {"predicted_label_index", "predicted_classname",
                                      "probabilities"}
    assert tout["predicted_label_index"] == jout["predicted_label_index"]
    assert tout["predicted_classname"] == jout["predicted_classname"]
    np.testing.assert_allclose(tout["probabilities"], jout["probabilities"], atol=1e-4)
    assert tout_b64 == tout


def test_api_errors(engines, monkeypatch):
    _, port_engine = engines
    with _Server(make_handler(port_engine)) as ts:
        code, out = _post(ts.url, json.dumps({"image_b64": "aGVsbG8=", "metadata": "ARM, True, 4"})
                          .encode(), "application/json")
        assert (code, out["error"]) == (400, "invalid image")
        # a format other than PNG with no OpenCV to decode it
        monkeypatch.setitem(sys.modules, "cv2", None)
        ok, jpg = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
        body, ctype = _multipart(jpg.tobytes(), "ARM, True, 4")
        code, out = _post(ts.url, body, ctype)
        assert (code, out["error"]) == (400, "unsupported image format")
        try:
            urllib.request.urlopen(f"{ts.url}/nope", timeout=10)
            raise AssertionError("expected a 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404


def _filtered_png(img, filters):
    """An RGB(A) PNG whose row y uses scanline filter filters[y % len(filters)]."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = x[y]
        prior = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(np.concatenate([[ft], (cur - pred) % 256]).astype(np.uint8))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (png.PNG_SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_matches_opencv(channels):
    rng = np.random.default_rng(channels)
    # smooth content, so libpng picks a mix of filters
    base = rng.integers(0, 256, (9, 11, channels), dtype=np.uint8)
    for img in (rng.integers(0, 256, (13, 17, channels), dtype=np.uint8),
                cv2.resize(base, (45, 37), interpolation=cv2.INTER_LINEAR)):
        ok, buf = cv2.imencode(".png", img)  # OpenCV's channel order is BGR(A)
        assert ok
        expect = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        got = png.decode_png(buf.tobytes())
        assert got.dtype == np.uint8 and got.shape == expect.shape
        np.testing.assert_array_equal(got, expect)
        # every scanline filter, with the same image through OpenCV
        data = _filtered_png(img, filters=(0, 1, 2, 3, 4))
        expect = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                              cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(png.decode_png(data), expect)
        np.testing.assert_array_equal(png.decode_png(data), img[:, :, :3])
        # and the writer
        enc = png.encode_png(img)
        np.testing.assert_array_equal(png.decode_png(enc), img[:, :, :3])
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(enc, np.uint8), cv2.IMREAD_UNCHANGED),
            cv2.cvtColor(img, cv2.COLOR_RGB2BGR if channels == 3 else cv2.COLOR_RGBA2BGRA))


def test_png_reader_refuses_bad_data():
    data = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")
    ok, gray = cv2.imencode(".png", np.zeros((4, 4), np.uint8))
    with pytest.raises(png.UnsupportedPNG):
        png.decode_png(gray.tobytes())


@pytest.mark.parametrize("shape", [(50, 60), (500, 333)])
def test_resize_matches_opencv_within_one_level(shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    expect = cv2.resize(img, (224, 224), interpolation=cv2.INTER_LINEAR)
    got = resize_u8(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8 and got.shape == (224, 224, 3)
    # OpenCV resizes uint8 in 11-bit fixed point; the port in fp32 and rounds
    assert np.abs(got.astype(int) - expect.astype(int)).max() <= 1


def test_service_needs_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="DEVICE=cpu"):
        run_service.build_engine()
    monkeypatch.setenv("DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_service.build_engine()
    monkeypatch.setenv("DEVICE", "cpu")
    # MAX_BATCH>1 builds the dynamic-batching frontend around the engine
    monkeypatch.setenv("MAX_BATCH", "4")
    monkeypatch.setenv("CNN_MODEL_NAME", "resnet-18")
    batcher = run_service.build_engine()
    try:
        assert isinstance(batcher, BatchingEngine) and batcher.max_batch == 4
        assert batcher.engine.device == torch.device("cpu")
    finally:
        batcher.shutdown()
    # XAI=1 serves the XAI app on the engine itself: no batching frontend
    monkeypatch.setenv("XAI", "1")
    engine = run_service.build_engine()
    assert isinstance(engine, InferenceEngine) and engine.device == torch.device("cpu")


def test_service_builds_from_its_environment(monkeypatch, tmp_path):
    fz_path = str(tmp_path / "featurizer.json")
    _featurizer(MetadataFeaturizer).save(fz_path)
    # the service's model: the featurizer's widths, the default text tower and mechanism
    ckpt = init_weights(MultimodalModel(num_classes=4, num_heads=4, cnn_model_name="resnet-18",
                                        common_dim=32, vocab_size=7,
                                        attention_mechanism=CFG["attention_mechanism"]), seed=5)
    torch.save({f"module.{k}": v for k, v in ckpt.state_dict().items()},  # DataParallel keys
               str(tmp_path / "model.pt"))
    for k, v in dict(DEVICE="cpu", FEATURIZER_JSON=fz_path, CNN_MODEL_NAME="resnet-18",
                     COMMON_DIM="32", NUM_HEADS="4",
                     MODEL_CHECKPOINT=str(tmp_path / "model.pt")).items():
        monkeypatch.setenv(k, v)
    engine = run_service.build_engine()
    assert engine.fused and engine.model.dtype == torch.bfloat16
    assert engine.class_names == ["ACK", "BCC", "MEL", "NEV"]
    served = engine.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in ckpt.state_dict().items())
    out = engine.predict(np.zeros((40, 30, 3), np.uint8), "NECK, False, 70")
    assert abs(sum(out["probabilities"]) - 1.0) < 1e-3


def test_port_never_imports_jax():
    """Nor OpenCV, matplotlib, pandas, transformers, safetensors or tokenizers at
    import time: the card's machine has none of them, and the plots import
    matplotlib only when they draw. The XAI slice (the CAM family, the
    perturbation and tabular explainers, the app and the CLI) and the NAS
    slice (the supernet, the population trainer, the searchers and the NAS
    CLI) included."""
    code = (
        "import sys\n"
        "import skinjax_torch, skinjax_torch.serve.engine, skinjax_torch.serve.api\n"
        "import skinjax_torch.serve.run_service, skinjax_torch.models.weights\n"
        "import skinjax_torch.data.augment, skinjax_torch.data.pipeline\n"
        "import skinjax_torch.data.sampling, skinjax_torch.data.splits\n"
        "import skinjax_torch.ops.augment_kernel, skinjax_torch.eval.artifacts\n"
        "import skinjax_torch.train.losses, skinjax_torch.train.optimizer\n"
        "import skinjax_torch.train.steps, skinjax_torch.train.early_stopping\n"
        "import skinjax_torch.train.checkpoint, skinjax_torch.train.metrics\n"
        "import skinjax_torch.train.loop, skinjax_torch.train.kfold\n"
        "import skinjax_torch.ops.global_attention, skinjax_torch.ops.attention\n"
        "import skinjax_torch.models.backbones.vit, skinjax_torch.models.backbones.beit\n"
        "import skinjax_torch.data.tokenize, skinjax_torch.models.text.bert\n"
        "import skinjax_torch.models.text.gpt2, skinjax_torch.models.text.sentence\n"
        "import skinjax_torch.models.factory, skinjax_torch.train.experiments\n"
        "import skinjax_torch.tools.train_cli, skinjax_torch.ops.pooled_attention\n"
        "import skinjax_torch.models.backbones.mvit, skinjax_torch.ops.fused_mlp\n"
        "import skinjax_torch.models.backbones.caformer, skinjax_torch.models.backbones.coat\n"
        "import skinjax_torch.ops.channel_attention, skinjax_torch.ops.window_attention\n"
        "import skinjax_torch.models.backbones.swin, skinjax_torch.models.backbones.davit\n"
        "import skinjax_torch.ops.batch_norm, skinjax_torch.models.backbones.nextvit\n"
        "import skinjax_torch.models.backbones.cnn_zoo\n"
        "import skinjax_torch.models.fusion.blocks, skinjax_torch.models.fusion.sequence\n"
        "import skinjax_torch.models.baselines, skinjax_torch.models.text.static_embed\n"
        "import skinjax_torch.data.tabular, skinjax_torch.serve.batching\n"
        "import skinjax_torch.xai, skinjax_torch.serve.xai_app, skinjax_torch.tools.xai_cli\n"
        "import skinjax_torch.nas, skinjax_torch.nas.population, skinjax_torch.nas.supernet\n"
        "import skinjax_torch.nas.controller, skinjax_torch.nas.hpo, skinjax_torch.tools.nas_cli\n"
        "import skinjax_torch.tools.llm_client\n"
        "import chip_smoke\n"
        "banned = ('jax', 'jaxlib', 'flax', 'skinjax', 'cv2', 'matplotlib', 'transformers',\n"
        "          'safetensors', 'tokenizers', 'pandas')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
