"""Service entry point: build the model from environment variables and serve
HTTP (counterpart of ``skinjax/serve/run_service.py``, same variables).

  python -m skinjax_torch.serve.run_service

  MODEL_CHECKPOINT     the weights (optional; random weights from seed 0 without it): a
                       checkpoint of the port's trainer (the directory that
                       train.checkpoint.save_checkpoint writes, such as the train
                       CLI's <cell>_fold_<k>/best, or its state.pt), whose "model"
                       entry (parameters and BatchNorm buffers) is loaded, or a
                       torch.save'd state_dict
  FEATURIZER_JSON      persisted featurizer (required for raw-CSV inputs)
  CNN_MODEL_NAME, ATTENTION_MECHANISM, NUM_LABELS, NUM_HEADS, COMMON_DIM, VOCAB_SIZE
  HOST, PORT           default 0.0.0.0 and 8000
  DEVICE               torch device, default ``cuda``; ``cpu`` must be asked for
  MAX_BATCH            >1 wraps the engine in the dynamic-batching frontend
                       (serve/batching.py) with that many requests a forward
  BATCH_WAIT_MS        the batcher's linger (default 5 ms)
  XAI=1                serve the XAI demo app (serve/xai_app.py: the prediction and a
                       Grad-CAM++ overlay) instead of the JSON API; MAX_BATCH does not apply

The model runs in bfloat16 (autocast), as the JAX service does. TF32 is off
for both cuDNN and matmuls (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` are False): every fp32 product
the service asks for (the fusion gates, a fp32 model) is full fp32, as in
the JAX reference, and the bf16 towers do not use TF32 anyway.
"""

from __future__ import annotations

import os

import torch


def load_weights(path: str):
    """The model's state_dict from a trainer checkpoint (its directory or
    ``state.pt``) or from a bare state_dict file."""
    from skinjax_torch.train.checkpoint import FILE

    if os.path.isdir(path):
        path = os.path.join(path, FILE)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if {"model", "optimizer", "step"} <= set(sd):
        sd = sd["model"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def build_engine():
    """The engine the variables describe: an ``InferenceEngine``, or with
    MAX_BATCH > 1 (and not XAI=1) a ``BatchingEngine`` around it."""
    from skinjax_torch.data.featurizer import MetadataFeaturizer
    from skinjax_torch.models import MultimodalModel
    from skinjax_torch.models.weights import init_weights
    from skinjax_torch.serve.engine import InferenceEngine

    device = torch.device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"DEVICE={device} but CUDA is not available; set DEVICE=cpu to serve on the CPU"
        )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    fz = None
    fz_path = os.environ.get("FEATURIZER_JSON")
    if fz_path and os.path.exists(fz_path):
        fz = MetadataFeaturizer.load(fz_path)

    num_labels = int(os.environ.get("NUM_LABELS", fz.num_classes if fz else 6))
    vocab = int(os.environ.get("VOCAB_SIZE", fz.dim if fz else 91))
    model = MultimodalModel(
        num_classes=num_labels,
        num_heads=int(os.environ.get("NUM_HEADS", 8)),
        cnn_model_name=os.environ.get("CNN_MODEL_NAME", "resnet-50"),
        common_dim=int(os.environ.get("COMMON_DIM", 512)),
        vocab_size=vocab,
        attention_mechanism=os.environ.get(
            "ATTENTION_MECHANISM", "att-intramodal+residual+cross-attention-metadados"
        ),
        dtype=torch.bfloat16,
    )
    ckpt = os.environ.get("MODEL_CHECKPOINT")
    if ckpt and os.path.exists(ckpt):
        model.load_state_dict(load_weights(ckpt))
    else:
        init_weights(model, seed=0)
    engine = InferenceEngine(model, fz, device=device)
    max_batch = int(os.environ.get("MAX_BATCH", 1))
    if max_batch > 1 and os.environ.get("XAI") != "1":
        from skinjax_torch.serve.batching import BatchingEngine

        return BatchingEngine(engine, max_batch=max_batch,
                              max_wait_ms=float(os.environ.get("BATCH_WAIT_MS", 5.0)))
    return engine


def main():
    engine = build_engine()
    host, port = os.environ.get("HOST", "0.0.0.0"), int(os.environ.get("PORT", 8000))
    if os.environ.get("XAI") == "1":
        from skinjax_torch.serve.xai_app import serve_xai

        serve_xai(engine, engine.model, host, port)
        return
    from skinjax_torch.serve.api import serve

    serve(engine, host, port)


if __name__ == "__main__":
    main()
