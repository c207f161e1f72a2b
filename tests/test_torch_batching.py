"""The port's dynamic-batching frontend (``serve/batching.py``) on the cases
of ``tests/test_batching.py``: buckets, concurrent requests equal to serial
ones with forwards grouped, errors raised in every caller rather than hung,
an abandoned request dropped by the worker, the HTTP service over it, a bare
request given its batch axis, the idle fast path, uint8 and float requests;
and the fused engine (K1–K4's twins on the CPU) batched at B = 2 and 4
against its unbatched answers."""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from skinjax_torch.data.featurizer import MetadataFeaturizer
from skinjax_torch.models import MultimodalModel
from skinjax_torch.models.weights import init_weights
from skinjax_torch.serve import png
from skinjax_torch.serve.api import make_handler
from skinjax_torch.serve.batching import BatchingEngine, _bucket, _Pending
from skinjax_torch.serve.engine import InferenceEngine, preprocess_image, preprocess_image_u8
from tests.test_torch_serve import _featurizer
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

RGATT = "att-intramodal+residual+cross-attention-metadados"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(mech="concatenation", use_fused=False):
    fz = _featurizer(MetadataFeaturizer)
    model = init_weights(MultimodalModel(num_classes=4, num_heads=4, cnn_model_name="custom-cnn",
                                         common_dim=32, text_encoder_dim_output=32,
                                         vocab_size=fz.dim, attention_mechanism=mech), seed=0)
    return InferenceEngine(model, fz, use_fused=use_fused, device="cpu")


def test_bucket_sizes():
    assert [_bucket(n, 32) for n in (1, 2, 3, 5, 9, 32, 40)] == [1, 2, 4, 8, 16, 32, 32]


@pytest.fixture(scope="module")
def batcher():
    eng = BatchingEngine(_engine(), max_batch=8, max_wait_ms=30.0)
    yield eng
    eng.shutdown()


def _concurrently(fn, n):
    results = [None] * n

    def worker(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_concurrent_predictions_match_serial(batcher):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    lines = [f"ARM, True, {20 + i}" for i in range(12)]
    serial = [batcher.engine.predict(imgs[i], lines[i]) for i in range(12)]
    results = _concurrently(lambda i: batcher.predict(imgs[i], lines[i]), 12)
    for got, want in zip(results, serial):
        assert got["predicted_label_index"] == want["predicted_label_index"]
        np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=1e-5)
    # 12 concurrent requests with a 30 ms linger: some forward grouped > 1
    assert batcher.stats["batched_requests"] > 0
    assert batcher.stats["batches"] < batcher.stats["requests"]


def test_error_fans_out_not_hangs(batcher):
    img = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(ValueError):
        batcher.predict(img, "not,enough")  # the featurizer's arity, in the caller
    bad = BatchingEngine(batcher.engine, max_batch=4, max_wait_ms=10.0)
    orig = bad.engine.predict_probs
    try:
        def boom(*a):
            raise RuntimeError("boom")

        bad.engine.predict_probs = boom
        with bad._direct:  # through the worker: every waiter of the batch gets the error
            errors = _concurrently(lambda i: _raised(lambda: bad.predict_probs_queued(
                np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 7), np.float32))), 3)
        assert all(isinstance(e, RuntimeError) and str(e) == "boom" for e in errors)
        with pytest.raises(RuntimeError):  # and on the fast path
            bad.predict_probs_queued(np.zeros((1, 32, 32, 3), np.float32),
                                     np.zeros((1, 7), np.float32))
    finally:
        bad.engine.predict_probs = orig
        bad.shutdown()


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - returned to the test
        return e
    return None


def test_timed_out_request_is_skipped_by_worker(batcher):
    eng = BatchingEngine(batcher.engine, max_batch=4, max_wait_ms=5.0, timeout_s=0.05)
    orig = eng.engine.predict_probs
    try:
        calls = []
        release = threading.Event()

        def slow_predict(im, ft):
            calls.append(im.shape[0])
            release.wait(2.0)
            return orig(im, ft)

        eng.engine.predict_probs = slow_predict
        p_block = _Pending(np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 7), np.float32))
        eng._q.put(p_block)  # the worker takes it and blocks in the forward
        time.sleep(0.1)
        with eng._direct:  # no fast path
            with pytest.raises(TimeoutError):
                eng.predict_probs_queued(np.zeros((1, 32, 32, 3), np.float32),
                                         np.zeros((1, 7), np.float32))
        release.set()
        assert p_block.event.wait(3.0)
        time.sleep(0.3)  # the worker drains the abandoned entry
        assert calls == [1]  # only the blocking request ran a forward
    finally:
        eng.engine.predict_probs = orig
        eng.shutdown()


def test_http_api_with_batching(batcher):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    handler = server.RequestHandlerClass
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        img = np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        body = (b"--xBOUNDx\r\n"
                b'Content-Disposition: form-data; name="file"; filename="a.png"\r\n'
                b"\r\n" + png.encode_png(img) + b"\r\n"
                b"--xBOUNDx\r\n"
                b'Content-Disposition: form-data; name="metadata"\r\n'
                b"\r\nFACE, False, 41\r\n"
                b"--xBOUNDx--\r\n")
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict/", data=body,
            headers={"Content-Type": "multipart/form-data; boundary=xBOUNDx"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert set(out) == {"predicted_label_index", "predicted_classname", "probabilities"}
        assert len(out["probabilities"]) == 4
        np.testing.assert_allclose(out["probabilities"],
                                   batcher.engine.predict(img, "FACE, False, 41")["probabilities"],
                                   atol=1e-5)
    finally:
        server.shutdown()
        server.server_close()
        handler.worker.shutdown()


def test_unbatched_request_rank_normalized(batcher):
    probs = batcher.predict_probs_queued(np.zeros((32, 32, 3), np.float32),
                                         np.zeros(batcher.engine.featurizer.dim, np.float32))
    assert probs.shape[0] == 1
    with pytest.raises(ValueError, match="ONE request"):
        batcher.predict_probs_queued(np.zeros((2, 32, 32, 3), np.float32),
                                     np.zeros((2, 7), np.float32))


def test_lone_request_takes_direct_fast_path(batcher):
    before = batcher.stats["direct_requests"]
    batcher.predict_probs_queued(np.zeros((1, 32, 32, 3), np.float32),
                                 np.zeros((1, batcher.engine.featurizer.dim), np.float32))
    assert batcher.stats["direct_requests"] == before + 1


def test_uint8_requests_normalize_on_device(batcher):
    eng = batcher.engine
    feats = np.zeros((1, eng.featurizer.dim), np.float32)
    raw = np.random.default_rng(3).integers(0, 256, (40, 30, 3), dtype=np.uint8)
    f32, u8 = preprocess_image(raw, size=(32, 32)), preprocess_image_u8(raw, size=(32, 32))
    assert f32.dtype == np.float32 and u8.dtype == np.uint8 and u8.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(eng.predict_probs(u8, feats), eng.predict_probs(f32, feats),
                               atol=1e-4)
    results = {}

    def call(key, img):
        results[key] = batcher.predict_probs_queued(img, feats)

    ts = [threading.Thread(target=call, args=("f32", f32)),
          threading.Thread(target=call, args=("u8", u8))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    np.testing.assert_allclose(results["u8"], results["f32"], atol=1e-4)


def test_fused_engine_batches_match_unbatched():
    """RG-ATT on the fused route (K1 and K2, and K3, on their CPU twins) at the
    batching buckets 2 and 4: each row as the unbatched engine answers it."""
    eng = _engine(RGATT, use_fused=True)
    assert eng.fused
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    feats = rng.normal(size=(4, eng.featurizer.dim)).astype(np.float32)
    single = np.concatenate([eng.predict_probs(imgs[i:i + 1], feats[i:i + 1]) for i in range(4)])
    for b in (2, 4):
        np.testing.assert_allclose(eng.predict_probs(imgs[:b], feats[:b]), single[:b], atol=1e-5)
    batcher = BatchingEngine(eng, max_batch=4, max_wait_ms=30.0)
    try:
        with batcher._direct:  # all four through the worker
            got = _concurrently(lambda i: batcher.predict_probs_queued(imgs[i], feats[i]), 4)
    finally:
        batcher.shutdown()
    np.testing.assert_allclose(np.concatenate(got), single, atol=1e-5)
    assert batcher.stats["batched_requests"] > 0
