"""The multimodal classifier: image tower + metadata tower + fusion stage
(counterpart of ``skinjax/models/fusion/multimodal.py``).

Same configuration strings and the same math per mechanism as the JAX
model. Eight of its eighteen mechanisms are ported: the ones the fused
serving engine runs with the three fusion kernels alone. The others raise
``NotImplementedError``.

Like flax, which creates parameters only for the submodules a mechanism
calls, the model holds only the submodules its mechanism uses, so its
``state_dict()`` and the JAX parameter tree convert one to one
(``skinjax_torch.models.weights``).

Input is NHWC ``(B, H, W, 3)`` and featurized metadata ``(B, vocab_size)``.
``dtype=torch.bfloat16`` runs the model under autocast, the counterpart of
the JAX model's ``dtype=bfloat16``; parameters stay fp32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from skinjax_torch.models.backbones import create_backbone
from skinjax_torch.models.fusion.blocks import GatedAlteredResidualBlock, MLPHead
from skinjax_torch.models.text import OneHotMLP
from skinjax_torch.ops.attention import MultiheadAttention

MECHANISMS = (
    "no-metadata",
    "no-metadata-without-mlp",
    "concatenation",
    "crossattention",
    "weighted",
    "gfcam",
    "cross-weights-after-crossattention",
    "metablock",
    "rg-att2fusefeatures",
    "rg-att",
    "att-intramodal",
    "att-intramodal+residual",
    "cross-attention-only",
    "residual+cross-attention-metadados",
    "att-intramodal+residual+cross-attention-metadados",
    "att-intramodal+residual+cross-attention-metadados+rg-att2fusefeatures",
    "att-intramodal+residual+cross-attention-metadados+metablock",
    "att-intramodal+residual+cross-attention-metadados+att-intramodal+residual",
)

_RGATT = "att-intramodal+residual+cross-attention-metadados"

_CROSS_FAMILY = ("crossattention", "gfcam", "cross-weights-after-crossattention")
PORTED_MECHANISMS = (
    "concatenation", "weighted", "cross-attention-only", "rg-att", *_CROSS_FAMILY, _RGATT,
)


class FusionOps(NamedTuple):
    """The three primitives the fusion stage is built from, each addressed by
    the name of the submodule that holds its weights. The model's own are its
    modules; the fused serving engine passes the CUDA kernels instead."""

    attend: Callable  # (name, q, kv) -> seq-1 attention, (B, D)
    residual: Callable  # (name, q, kv) -> gated residual block, (B, D)
    gate: Callable  # (name, x) -> sigmoid(linear(x)), (B, D)


class MultimodalModel(nn.Module):
    def __init__(
        self,
        num_classes: int,
        num_heads: int = 8,
        cnn_model_name: str = "resnet-50",
        text_model_name: str = "one-hot-encoder",
        common_dim: int = 512,
        text_encoder_dim_output: int = 512,
        vocab_size: int = 91,
        attention_mechanism: str = "concatenation",
        dropout_rate: float = 0.5,
        dtype: Optional[torch.dtype] = None,
        *,
        device=None,
    ):
        super().__init__()
        mech = attention_mechanism
        if mech not in MECHANISMS:
            raise ValueError(f"Attention mechanism '{mech}' not implemented. Known: {MECHANISMS}")
        if mech not in PORTED_MECHANISMS:
            raise NotImplementedError(
                f"mechanism '{mech}' is not ported to PyTorch yet (ported: "
                f"{PORTED_MECHANISMS}); ROADMAP.md lists when it comes"
            )
        if text_model_name != "one-hot-encoder":
            raise NotImplementedError(
                f"text tower '{text_model_name}' is not ported to PyTorch yet; "
                "ROADMAP.md lists when it comes"
            )
        self.num_classes = num_classes
        self.common_dim = common_dim
        self.vocab_size = vocab_size
        self.attention_mechanism = mech
        self.dtype = dtype

        self.image_encoder, self.cnn_dim_output = create_backbone(cnn_model_name, device=device)
        self.image_projector = nn.Linear(self.cnn_dim_output, common_dim, device=device)
        self.text_fc = OneHotMLP(vocab_size, text_encoder_dim_output, device=device)
        self.text_projector = nn.Linear(text_encoder_dim_output, common_dim, device=device)

        mha = lambda: MultiheadAttention(common_dim, num_heads, device=device)  # noqa: E731
        if mech in (*_CROSS_FAMILY, _RGATT):
            self.image_self_attention = mha()
            self.text_self_attention = mha()
        if mech in (*_CROSS_FAMILY, "cross-attention-only", _RGATT):
            self.image_cross_attention = mha()
            self.text_cross_attention = mha()
        if mech in ("weighted", "gfcam", "cross-weights-after-crossattention"):
            self.img_gate = nn.Linear(common_dim, common_dim, device=device)
            self.txt_gate = nn.Linear(common_dim, common_dim, device=device)
        if mech in ("rg-att", _RGATT):
            # 8 heads whatever num_heads is, as in the JAX model; at seq-1
            # the head count changes nothing
            self.image_residual = GatedAlteredResidualBlock(common_dim, device=device)
            self.text_residual = GatedAlteredResidualBlock(common_dim, device=device)
        self.fc_fusion = MLPHead(2 * common_dim, common_dim, num_classes, dropout_rate,
                                 device=device)

    def autocast(self, device: torch.device):
        """Autocast to the model's compute dtype, or nothing for fp32."""
        if self.dtype is None or self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.dtype)

    def features(self, image: torch.Tensor, metadata: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both towers and projectors: (proj_img, proj_txt), each (B, common_dim)."""
        with self.autocast(image.device):
            img_feat = self.image_encoder(image)
            if img_feat.dim() == 4:  # NHWC map → GAP
                img_feat = img_feat.mean(dim=(1, 2))
            elif img_feat.dim() == 3:  # token sequence → CLS
                img_feat = img_feat[:, 0]
            proj_img = self.image_projector(img_feat)
            proj_txt = self.text_projector(self.text_fc(metadata))
        return proj_img, proj_txt

    def module_ops(self) -> FusionOps:
        """The primitives as this model's submodules."""

        def seq1(name, q, kv):  # the named attention or residual block, on (B, D)
            kv = kv[:, None]
            return getattr(self, name)(q[:, None], kv, kv)[:, 0]

        return FusionOps(seq1, seq1, lambda name, x: torch.sigmoid(getattr(self, name)(x)))

    def fuse(self, img: torch.Tensor, txt: torch.Tensor,
             ops: Optional[FusionOps] = None) -> torch.Tensor:
        """The fusion stage on projected features → (B, 2 * common_dim)."""
        attend, residual, gate = ops or self.module_ops()
        mech = self.attention_mechanism
        if mech == "concatenation":
            return torch.cat([img, txt], dim=-1)
        if mech == "weighted":
            return torch.cat([gate("img_gate", img) * img, gate("txt_gate", txt) * txt], dim=-1)
        if mech == "cross-attention-only":
            return torch.cat([attend("image_cross_attention", img, txt),
                              attend("text_cross_attention", txt, img)], dim=-1)
        if mech == "rg-att":
            return torch.cat([residual("image_residual", img, txt),
                              residual("text_residual", txt, img)], dim=-1)
        img_att = attend("image_self_attention", img, img)
        txt_att = attend("text_self_attention", txt, txt)
        if mech == _RGATT:
            img_att = residual("image_residual", img, img_att)
            txt_att = residual("text_residual", txt, txt_att)
        img_x = attend("image_cross_attention", img_att, txt_att)
        txt_x = attend("text_cross_attention", txt_att, img_att)
        if mech in ("crossattention", _RGATT):
            return torch.cat([img_x, txt_x], dim=-1)
        a_img, a_txt = gate("img_gate", img_x), gate("txt_gate", txt_x)
        if mech == "gfcam":
            return torch.cat([a_img * img_x, a_txt * txt_x], dim=-1)
        return torch.cat([a_txt * img_x, a_img * txt_x], dim=-1)  # swapped gates

    def forward(self, image: torch.Tensor, metadata: torch.Tensor) -> torch.Tensor:
        """image (B, H, W, 3) NHWC, metadata (B, vocab_size) → logits (B, num_classes)."""
        proj_img, proj_txt = self.features(image, metadata)
        with self.autocast(image.device):
            return self.fc_fusion(self.fuse(proj_img, proj_txt))
