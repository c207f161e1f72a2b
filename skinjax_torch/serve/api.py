"""HTTP inference service on the Python standard library (counterpart of
``skinjax/serve/api.py``: same endpoints, same response JSON).

Endpoints:
  GET  /health    -> {"status": "ok"}
  POST /predict/  multipart/form-data with fields ``file`` (image bytes) and
                  ``metadata`` (one raw CSV line in training column order), or
                  a JSON body {"image_b64": ..., "metadata": ...}
                  -> {"predicted_label_index", "predicted_classname",
                      "probabilities"}

Images are decoded without OpenCV where possible: 8-bit RGB/RGBA PNGs go
through ``skinjax_torch.serve.png``. Other formats need ``cv2``; without it
the answer is 400 ``unsupported image format``.

The server starts a thread per request, but every forward runs on one
persistent inference thread: PyTorch sets up CUDA state per thread on first
use (cuDNN and cuBLAS handles, convolution plans), which cost the flagship
about 0.1 s per request on an H100 when each request ran on a fresh thread.
The card runs one forward at a time anyway. A ``BatchingEngine``
(``serve/batching.py``) is called from the request threads instead: its own
worker thread runs the batched forwards, and a request that finds it idle
runs directly in its thread.
"""

from __future__ import annotations

import base64
import binascii
import json
import re
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from skinjax_torch.serve import png
from skinjax_torch.serve.engine import InferenceEngine


class ImageError(ValueError):
    """An upload that cannot be decoded; its message is the 400 response."""


def _parse_multipart(body: bytes, content_type: str):
    m = re.search(r"boundary=([^;]+)", content_type)
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = m.group(1).strip('"').encode()
    fields = {}
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        # each payload ends in exactly CRLF before the next boundary; binary
        # payloads may themselves end in '-', '\r' or '\n', so strip no more
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        # anchored so that 'filename="..."' cannot shadow the 'name' parameter
        nm = re.search(rb'(?:^|;\s*)name="([^"]+)"', head, re.M)
        if nm:
            fields[nm.group(1).decode()] = payload
    return fields


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes → uint8 (H, W, 3) RGB, or ``ImageError``."""
    if data.startswith(png.PNG_SIGNATURE):
        try:
            return png.decode_png(data)
        except png.UnsupportedPNG:
            pass  # another PNG kind: OpenCV below, where present
        except ValueError as e:
            raise ImageError("invalid image") from e
    try:
        import cv2
    except ImportError:
        raise ImageError("unsupported image format") from None
    img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ImageError("invalid image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def make_handler(engine: InferenceEngine):  # or a BatchingEngine
    """The request handler class; ``Handler.worker`` is its inference thread
    (shut it down when the server stops)."""

    class Handler(BaseHTTPRequestHandler):
        worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="skinjax-infer")

        def _json(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/health"):
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("multipart/form-data"):
                    fields = _parse_multipart(body, ctype)
                    img_bytes = fields.get("file", b"")
                    metadata = fields.get("metadata", b"").decode()
                else:
                    payload = json.loads(body)
                    img_bytes = base64.b64decode(payload["image_b64"])
                    metadata = payload["metadata"]
                img = decode_image(img_bytes)
            except ImageError as e:
                return self._json(400, {"error": str(e)})
            except (ValueError, KeyError, TypeError, binascii.Error) as e:
                return self._json(400, {"error": f"bad request: {type(e).__name__}: {e}"})
            try:
                if hasattr(engine, "predict_probs_queued"):  # a BatchingEngine
                    result = engine.predict(img, metadata)
                else:
                    result = self.worker.submit(engine.predict, img, metadata).result()
            except Exception as e:  # noqa: BLE001 - serving boundary: report, keep serving
                traceback.print_exc()
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            self._json(200, result)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve(engine: InferenceEngine, host: str = "0.0.0.0", port: int = 8000):
    handler = make_handler(engine)
    server = ThreadingHTTPServer((host, port), handler)
    print(f"skinjax_torch inference service on {host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        handler.worker.shutdown()
