"""Inference engine with a CUDA-fused fusion stage (counterpart of
``skinjax/serve/engine.py``).

Loads a ``MultimodalModel`` and a persisted featurizer, turns an image and a
raw metadata CSV line into the model's inputs, runs one forward and returns
the class and the probabilities.

``use_fused=True`` runs the fusion stage of the ten mechanisms in
``FUSED_MECHANISMS`` (the JAX engine's set) with the kernels of
``skinjax_torch.ops.fusion_kernels`` (on a CUDA device; on the CPU the same
calls take their plain twins); the other eight take the plain forward, as in
JAX. ``metablock`` runs K4 on the raw tower features and K3 on its head;
``…+metablock`` runs the RG-ATT chain on K1/K2, then K4, then its one linear
layer as a matrix product. The fused weights are packed once, at
construction, into contiguous fp32 ``(in, out)`` tensors on the device: load
new weights into the model before building the engine.

Precision: the towers and projectors run under autocast to the model's
``dtype`` (bfloat16 in the service). The fusion stage runs outside autocast:
the kernels take the bf16 activations with fp32 weights and accumulate in
fp32, as the JAX kernels do; gates ``σ(x @ W + b)`` are fp32. Softmax is fp32.

Image input: a uint8 batch is normalized on the device in fp32 and then cast
to the model dtype; any image size is resized to 224×224 on the device,
bilinear with half-pixel centres and no antialias (OpenCV's
``INTER_LINEAR``), and rounded back to uint8 as OpenCV's resize would.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skinjax_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from skinjax_torch.data.featurizer import MetadataFeaturizer
from skinjax_torch.models.fusion.multimodal import _RGATT, FusionOps, MultimodalModel
from skinjax_torch.ops import fusion_kernels as fk

IMAGE_SIZE = (224, 224)
FUSED_MECHANISMS = (
    "concatenation", "crossattention", "weighted", "gfcam",
    "cross-weights-after-crossattention", "metablock", "rg-att",
    "cross-attention-only", _RGATT, _RGATT + "+metablock",
)


def resize_u8(image_u8: torch.Tensor, size: Tuple[int, int] = IMAGE_SIZE) -> torch.Tensor:
    """uint8 (H, W, 3) on any device → uint8 (h, w, 3) on the same device."""
    if tuple(image_u8.shape[:2]) == tuple(size):
        return image_u8
    x = image_u8.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=False)
    return x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)


def preprocess_image_u8(image_u8: np.ndarray, size: Tuple[int, int] = IMAGE_SIZE) -> np.ndarray:
    """uint8 HWC (any size) → resized uint8 (1, h, w, 3) on the host, by
    ``resize_u8``'s arithmetic; the engine normalizes it on the device."""
    return resize_u8(torch.from_numpy(np.ascontiguousarray(image_u8)), size).numpy()[None]


def preprocess_image(image_u8: np.ndarray, size: Tuple[int, int] = IMAGE_SIZE) -> np.ndarray:
    """uint8 HWC (any size) → normalized float32 (1, h, w, 3) on the host."""
    img = preprocess_image_u8(image_u8, size).astype(np.float32) / 255.0
    return ((img - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32)).astype(np.float32)


def _mha(mha) -> List[torch.Tensor]:
    w, b = mha.v_proj()
    return [w.t(), b, mha.out_proj.weight.t(), mha.out_proj.bias]


def _grb(block) -> List[torch.Tensor]:
    return _mha(block.attn) + [block.gate_linear.weight.t(), block.gate_linear.bias,
                               block.norm.weight, block.norm.bias]


def _film(block) -> List[torch.Tensor]:
    return [block.fb[0].weight.t(), block.fb[0].bias, block.fb[1].weight, block.fb[1].bias,
            block.gb[0].weight.t(), block.gb[0].bias, block.gb[1].weight, block.gb[1].bias]


def _head(seq) -> List[torch.Tensor]:
    return [seq[0].weight.t(), seq[0].bias, seq[1].weight, seq[1].bias,
            seq[4].weight.t(), seq[4].bias, seq[5].weight, seq[5].bias,
            seq[8].weight.t(), seq[8].bias]


def _pack(tensors: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    return tuple(t.detach().float().contiguous() for t in tensors)


class InferenceEngine:
    def __init__(
        self,
        model: MultimodalModel,
        featurizer: Optional[MetadataFeaturizer] = None,
        class_names: Optional[Sequence[str]] = None,
        use_fused: bool = True,
        *,
        device,
    ):
        self.device = torch.device(device)
        model = model.to(self.device).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self.featurizer = featurizer
        self.class_names = list(
            class_names or (featurizer.label_encoder.classes if featurizer else [])
        )
        self.fused = use_fused and model.attention_mechanism in FUSED_MECHANISMS
        self.dtype = model.dtype or torch.float32
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)
        self._w: Dict[str, Tuple[torch.Tensor, ...]] = {}
        if self.fused:
            self._pack_weights()
        self._forward: Callable = self._fused_forward if self.fused else self._plain_forward

    def _pack_weights(self) -> None:
        m = self.model
        names = {
            "image_self_attention": _mha, "text_self_attention": _mha,
            "image_cross_attention": _mha, "text_cross_attention": _mha,
            "image_residual": _grb, "text_residual": _grb, "meta_block": _film,
        }
        with torch.no_grad():
            for name, adapter in names.items():
                if hasattr(m, name):
                    self._w[name] = _pack(adapter(getattr(m, name)))
            for name in ("img_gate", "txt_gate"):
                if hasattr(m, name):
                    lin = getattr(m, name)
                    self._w[name] = _pack([lin.weight.t(), lin.bias])
            head = getattr(m, m.head_name)
            self._w["head"] = _pack([head.weight.t(), head.bias] if isinstance(head, torch.nn.Linear)
                                    else _head(head))
        w, dt = self._w, self.dtype
        # the fusion stage's primitives as kernels on the packed weights; K4
        # takes both inputs in the model dtype (a DaViT tower's LayerNorm
        # returns fp32 under autocast)
        self._ops = FusionOps(
            attend=lambda name, q, kv: fk.seq1_attention(kv, *w[name]),
            residual=lambda name, q, kv: fk.gated_residual_seq1(q, kv, *w[name]),
            gate=lambda name, x: torch.sigmoid(x.float() @ w[name][0] + w[name][1]),
            film=lambda name, v, u: fk.metablock_film(v.to(dt).contiguous(),
                                                      u.to(dt).contiguous(), *w[name]),
        )

    # -- forwards -----------------------------------------------------------
    def _plain_forward(self, image, metadata):
        logits = self.model(image, metadata)
        return torch.softmax(logits.float(), dim=-1)

    def _fused_forward(self, image, metadata):
        img, txt = self.model.features(image, metadata)
        fused = self.model.fuse(img, txt, self._ops)
        head = self._w["head"]
        if len(head) == 2:  # fc_fusion_proj_feat2output, a matrix product as in JAX
            logits = fused.float() @ head[0] + head[1]
        else:
            logits = fk.mlp_head(fused.contiguous(), *head)
        return torch.softmax(logits.float(), dim=-1)

    def _normalize_u8(self, image_u8: torch.Tensor) -> torch.Tensor:
        img = image_u8.float() / 255.0
        return ((img - self._mean) / self._std).to(self.dtype)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x)).to(self.device, non_blocking=True)

    # -- public API ---------------------------------------------------------
    @torch.inference_mode()
    def predict_probs(self, image: np.ndarray, metadata: np.ndarray) -> np.ndarray:
        """image: normalized float (B, H, W, 3) or uint8 (B, H, W, 3), which
        normalizes on the device; metadata: featurized (B, F)."""
        image = np.asarray(image)
        if image.dtype == np.uint8:
            x = self._normalize_u8(self._to_device(image))
        else:
            x = self._to_device(image.astype(np.float32, copy=False))
        meta = self._to_device(np.asarray(metadata, np.float32))
        return self._forward(x, meta).cpu().numpy()

    @torch.inference_mode()
    def predict(self, image_u8: np.ndarray, metadata_csv_line: str) -> Dict:
        """Raw image (any size, uint8 HWC RGB) + raw CSV line → the
        ``POST /predict/`` response."""
        if self.featurizer is None:
            raise ValueError("predict() on raw inputs requires a featurizer")
        feats = self._featurize_csv_line(metadata_csv_line)
        img = resize_u8(self._to_device(image_u8))[None]
        meta = self._to_device(feats.astype(np.float32))
        probs = self._forward(self._normalize_u8(img), meta)[0].cpu().numpy()
        idx = int(probs.argmax())
        return {
            "predicted_label_index": idx,
            "predicted_classname": self.class_names[idx] if self.class_names else str(idx),
            "probabilities": probs.tolist(),
        }

    def _featurize_csv_line(self, line: str) -> np.ndarray:
        fz = self.featurizer
        cols = fz.categorical_cols + fz.numerical_cols
        vals = [v.strip() for v in line.split(",")]
        if len(vals) != len(cols):
            raise ValueError(f"expected {len(cols)} metadata values ({cols}), got {len(vals)}")
        table = {}
        for c, v in zip(cols, vals):
            if c in fz.numerical_cols:
                try:
                    table[c] = np.asarray([float(v) if v not in ("", "EMPTY") else -1.0])
                except ValueError:
                    table[c] = np.asarray([-1.0])
            else:
                table[c] = np.asarray([v if v else "EMPTY"], dtype=object)
        return fz.transform(table)

    @torch.inference_mode()
    def measure_latency(self, n: int = 50, batch: int = 1,
                        image_size: Tuple[int, int] = IMAGE_SIZE) -> Dict:
        """p50/p95 of the forward on inputs already on the card, each timed
        on the host clock up to ``torch.cuda.synchronize()``. CUDA only."""
        if self.device.type != "cuda":
            raise RuntimeError("measure_latency times the CUDA device; this engine is on "
                               f"{self.device}")
        rng = np.random.default_rng(0)
        img = self._to_device(rng.normal(size=(batch, *image_size, 3)).astype(np.float32))
        meta = self._to_device(rng.normal(size=(batch, self.model.vocab_size)).astype(np.float32))
        self._forward(img, meta)
        torch.cuda.synchronize(self.device)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            self._forward(img, meta)
            torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
        times = np.sort(times)
        return {
            "p50_ms": float(np.percentile(times, 50) * 1e3),
            "p95_ms": float(np.percentile(times, 95) * 1e3),
            "mean_ms": float(times.mean() * 1e3),
            "device": torch.cuda.get_device_name(self.device),
        }
