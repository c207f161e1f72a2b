"""XAI demo web app on the standard library's HTTP server (counterpart of
``skinjax/serve/xai_app.py``, the reference's Gradio service): an image and
metadata fields in toggleable groups in, the prediction and a Grad-CAM++
overlay on the predicted class out.

  python -m skinjax_torch.serve.run_service    with XAI=1 (serve/run_service.py)

The metadata fields come in the reference's four groups (``METADATA_GROUPS``);
a group switched off sends neutral values (EMPTY, or -1 for a number), and
``build_metadata_values`` rebuilds the raw CSV line in training column order.
A POST to ``/analyze`` (multipart: ``file`` and the fields) is decoded
without OpenCV for PNGs (``serve/api.py`` ``decode_image``), predicted by the
engine (its fused K1–K3 path on the card), explained by ``grad_cam_pp``
through the model's own modules (the engine's fused path has no backward),
and answered with an HTML page whose overlay is a PNG from ``encode_png``
over the 224×224 image the model saw (``resize_u8``, as the engine resizes).
Neither matplotlib nor cv2 is needed.

As in ``serve/api.py``, the server starts a thread per request but the
forward and the CAM run on one persistent worker thread, since PyTorch sets
up CUDA state (cuDNN and cuBLAS handles) per thread on first use. Each answer
carries a ``Server-Timing`` header: the prediction, the CAM and the overlay's
encoding, in milliseconds on the host clock (each read after the card is
done). Error text is HTML-escaped, as skinjax escapes it (it can hold form
values).
"""

from __future__ import annotations

import base64
import html
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# PAD-UFES-20 field groups (the reference's metadata_groups.py:1-32)
METADATA_GROUPS: Dict[str, List[str]] = {
    "demographics": ["age", "gender", "fitspatrick", "background_father",
                     "background_mother"],
    "history": ["smoke", "drink", "pesticide", "skin_cancer_history",
                "cancer_history", "has_piped_water", "has_sanitation"],
    "symptoms": ["itch", "grew", "hurt", "changed", "bleed", "elevation"],
    "lesion_geometry": ["region", "diameter_1", "diameter_2"],
}


def build_metadata_values(values: Dict[str, str], enabled_groups: Sequence[str],
                          featurizer) -> str:
    """The group-gated CSV line in training column order (the reference's
    metadata_builder.py:11-38)."""
    enabled_fields = set()
    for g in enabled_groups:
        enabled_fields.update(METADATA_GROUPS.get(g, []))
    out = []
    for c in featurizer.categorical_cols + featurizer.numerical_cols:
        if c in enabled_fields and values.get(c, "") != "":
            out.append(str(values[c]))
        else:
            out.append("-1" if c in featurizer.numerical_cols else "EMPTY")
    return ",".join(out)


_PAGE = """<!doctype html><html><head><title>skinjax_torch XAI demo</title>
<style>body{font-family:sans-serif;max-width:900px;margin:2em auto}
fieldset{margin:.6em 0}label{display:inline-block;width:180px}
img{max-width:380px;border:1px solid #ccc;margin:4px}</style></head><body>
<h2>skinjax_torch — multimodal skin-lesion XAI demo</h2>
<form method="post" action="/analyze" enctype="multipart/form-data">
<p><input type="file" name="file" accept="image/*" required></p>
%FIELDSETS%
<p><button type="submit">Predict + explain</button></p>
</form>%RESULT%</body></html>"""


def _fieldsets(featurizer) -> str:
    cols = set(featurizer.categorical_cols + featurizer.numerical_cols)
    parts = []
    for group, fields in METADATA_GROUPS.items():
        rows = [f'<fieldset><legend><label><input type="checkbox" name="group_{group}"'
                f' checked> {group}</label></legend>']
        rows += [f'<label>{f}</label><input name="{f}"><br>' for f in fields if f in cols]
        rows.append("</fieldset>")
        parts.append("\n".join(rows))
    return "\n".join(parts)


def explain(engine, model, img_u8: np.ndarray, csv_line: str
            ) -> Tuple[Dict, bytes, Dict[str, float]]:
    """(the engine's prediction, the Grad-CAM++ overlay as PNG bytes, the
    milliseconds of the forward, the CAM and the encoding)."""
    from skinjax_torch.serve.engine import resize_u8
    from skinjax_torch.serve.png import encode_png
    from skinjax_torch.xai import grad_cam_pp, overlay_heatmap

    def now():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        return time.perf_counter()

    t0 = now()
    result = engine.predict(img_u8, csv_line)
    t1 = now()
    img224 = resize_u8(engine._to_device(img_u8))
    image = ((img224.float() / 255.0 - engine._mean) / engine._std)[None]
    meta = engine._to_device(engine._featurize_csv_line(csv_line).astype(np.float32))
    heat = grad_cam_pp(model, image, meta, [result["predicted_label_index"]])[0].cpu().numpy()
    t2 = now()
    png = encode_png(overlay_heatmap(img224.cpu().numpy(), heat))
    t3 = now()
    ms = {"forward": (t1 - t0) * 1e3, "cam": (t2 - t1) * 1e3, "encode": (t3 - t2) * 1e3}
    return result, png, ms


def make_xai_handler(engine, model):
    """The request handler class for an ``InferenceEngine`` and its model
    (the CAM's forward); ``Handler.worker`` is the inference thread (shut it
    down when the server stops)."""
    from skinjax_torch.serve.api import _parse_multipart, decode_image

    fz = engine.featurizer

    class Handler(BaseHTTPRequestHandler):
        worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="skinjax-xai")

        def _html(self, body: str, code: int = 200, timing: str = ""):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            if timing:
                self.send_header("Server-Timing", timing)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._html(_PAGE.replace("%FIELDSETS%", _fieldsets(fz)).replace("%RESULT%", ""))

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                fields = _parse_multipart(self.rfile.read(length),
                                          self.headers.get("Content-Type", ""))
                img_bytes = fields.pop("file", b"")
                values = {k: v.decode() for k, v in fields.items()}
                enabled = [g for g in METADATA_GROUPS if values.pop(f"group_{g}", None)]
                img_u8 = decode_image(img_bytes)
                csv_line = build_metadata_values(values, enabled, fz)
                result, png, ms = self.worker.submit(explain, engine, model, img_u8,
                                                     csv_line).result()
                probs = "".join(f"<li>{html.escape(str(c))}: {p:.3f}</li>"
                                for c, p in zip(engine.class_names, result["probabilities"]))
                b64 = base64.b64encode(png).decode()
                res = (f"<h3>Prediction: {html.escape(str(result['predicted_classname']))}</h3>"
                       f"<ul>{probs}</ul>"
                       f'<img src="data:image/png;base64,{b64}" alt="Grad-CAM++">')
                page = _PAGE.replace("%FIELDSETS%", _fieldsets(fz)).replace("%RESULT%", res)
                self._html(page, timing=", ".join(f"{k};dur={v:.3f}" for k, v in ms.items()))
            except Exception as e:  # noqa: BLE001 - serving boundary
                # the text can hold form values: escaped against reflected XSS
                self._html(f"<pre>error: {type(e).__name__}: {html.escape(str(e))}</pre>", 500)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def serve_xai(engine, model, host: str = "0.0.0.0", port: int = 7860):
    handler = make_xai_handler(engine, model)
    server = ThreadingHTTPServer((host, port), handler)
    print(f"skinjax_torch XAI demo on {host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        handler.worker.shutdown()
