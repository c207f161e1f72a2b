"""Sequence fusion and bilinear pooling (counterpart of
``skinjax/models/fusion/sequence.py``).

``SequenceFusionModel`` keeps the image tower's token sequence instead of
pooling it first: the tokens (``tokens=True`` of ViT/BEiT) projected to
``common_dim``, the metadata through the one-hot tower to ``meta_tokens``
learned tokens; self-attention within each sequence, cross-attention between
them, mean over each sequence, sigmoid-gated concatenation, MLP head. The
self-attentions (197 image tokens at 224×224, ``meta_tokens`` metadata
tokens) take the global attention core K12 where it admits the shape
(``ops/attention.py`` ``route``); the cross-attentions (Sq ≠ Skv) take the
plain path, as skinjax sends them to XLA.

Parameter names are skinjax's: ``backbone`` (flax's auto-named tower, as in
the baselines, so the freeze policy's ``image_encoder`` prefix does not reach
it, as in skinjax), ``img_proj``, ``text_tower`` (``0|2|4``), ``img_self``,
``txt_self``, ``img_cross``, ``txt_cross``, ``img_gate``, ``txt_gate`` and
``head`` (``0|1|4|5|8``). ``dtype=torch.bfloat16`` runs it under autocast.
``capture=True`` returns ``(logits, aux)`` with skinjax's aux: ``tokens``,
``img_pooled``, ``txt_pooled``.

``BilinearPooling``: ``proj(LN(u(x) * v(y)))``, low-rank bilinear fusion.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from skinjax_torch.models.backbones import create_backbone
from skinjax_torch.models.fusion.blocks import MLPHead, layer_norm
from skinjax_torch.models.fusion.multimodal import autocast_to
from skinjax_torch.models.text import OneHotMLP
from skinjax_torch.ops.attention import MultiheadAttention


class BilinearPooling(nn.Module):
    """Low-rank bilinear fusion: ``proj(LN(u(x) * v(y)))``."""

    def __init__(self, x_dim: int, y_dim: int, out_dim: int, rank: int = 256, *, device=None):
        super().__init__()
        self.u = nn.Linear(x_dim, rank, device=device)
        self.v = nn.Linear(y_dim, rank, device=device)
        self.norm = layer_norm(rank, device=device)
        self.proj = nn.Linear(rank, out_dim, device=device)

    def forward(self, x, y):
        return self.proj(self.norm(self.u(x) * self.v(y)))


class SequenceFusionModel(nn.Module):
    def __init__(self, num_classes: int, num_heads: int = 8,
                 cnn_model_name: str = "vit_small_patch16_224", common_dim: int = 512,
                 vocab_size: int = 91, meta_tokens: int = 4, dropout_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.common_dim = common_dim
        self.vocab_size = vocab_size
        self.meta_tokens = meta_tokens
        self.dtype = dtype
        self.backbone, feat_dim = create_backbone(cnn_model_name, device=device,
                                                  common_dim=common_dim)
        self.img_proj = nn.Linear(feat_dim, common_dim, device=device)
        self.text_tower = OneHotMLP(vocab_size, common_dim * meta_tokens, device=device)
        for name in ("img_self", "txt_self", "img_cross", "txt_cross"):
            self.add_module(name, MultiheadAttention(common_dim, num_heads, device=device))
        self.img_gate = nn.Linear(common_dim, common_dim, device=device)
        self.txt_gate = nn.Linear(common_dim, common_dim, device=device)
        self.head = MLPHead(2 * common_dim, common_dim, num_classes, dropout_rate, device=device)

    def forward(self, image: torch.Tensor, metadata: torch.Tensor, *, capture: bool = False):
        """image (B, H, W, 3) NHWC, metadata (B, vocab_size) → logits, or
        with ``capture`` (logits, aux)."""
        with autocast_to(self.dtype, image.device):
            tokens = self.backbone(image, tokens=True)  # (B, T, D_b)
            img_seq = self.img_proj(tokens)
            txt_seq = self.text_tower(metadata).reshape(-1, self.meta_tokens, self.common_dim)
            img_att = self.img_self(img_seq, img_seq, img_seq)
            txt_att = self.txt_self(txt_seq, txt_seq, txt_seq)
            img_x = self.img_cross(img_att, txt_att, txt_att)
            txt_x = self.txt_cross(txt_att, img_att, img_att)
            img_pooled, txt_pooled = img_x.mean(dim=1), txt_x.mean(dim=1)
            a_img = torch.sigmoid(self.img_gate(img_pooled))
            a_txt = torch.sigmoid(self.txt_gate(txt_pooled))
            fused = torch.cat([a_img * img_pooled, a_txt * txt_pooled], dim=-1)
            logits = self.head(fused)
        if capture:
            return logits, {"tokens": tokens, "img_pooled": img_pooled, "txt_pooled": txt_pooled}
        return logits
