"""The published baselines (counterpart of ``skinjax/models/baselines``):
MD-Net, LiwTERM and MetaNet.

Each takes ``(image (B, H, W, 3) NHWC, metadata (B, meta_dim))`` and returns
logits, or with ``capture=True`` ``(logits, aux)``, skinjax's aux: MD-Net's
and MetaNet's ``feature_map`` (the fused or gated map, (B, h, w, C), which
Score-CAM reads) and ``img_feat`` (its mean), LiwTERM's ``img_feat`` (the
tower's feature); ``dtype=torch.bfloat16`` runs it under autocast,
parameters fp32.

  ``MDNet``         DenseNet features → MetaNet channel gates + a spatial
                    MetaBlock, summed → mean over the map → ``classifier``.
                    The reference's names: ``feature_extractor.`` (the
                    DenseNet's ``features``), ``meta_net.metanet.{0,2}``,
                    ``meta_block.{fb,gb}.{0,1}``, ``classifier``, which
                    ``skinjax.models.torch_import.import_mdnet`` reads.
  ``LiwTERM``       a ViT's CLS feature → 4096 (``visual_proj``/``visual_norm``);
                    metadata → LN → 1024 (``meta_norm``/``meta_fc``); concat →
                    LN → 2048 → 1024 → 512 (``slm_*``) → ``slm_out``.
  ``MetaNetModel``  conv features gated by MetaNet (``metanet.metanet.{0,2}``)
                    → mean → fc1 → LN → fc2 (half) → LN → ``fc_out``.

skinjax builds each baseline's tower inside the module, where flax names it
after its class (``DenseNet_0``, ``ViT_0``, ``ResNet_0``), so its freeze
policy, which freezes what lies under ``image_encoder``, never reaches it:
every baseline trains all its parameters in every freeze mode. The port
keeps that: the towers sit under ``feature_extractor`` (MDNet) and
``backbone`` (the other two), not under ``image_encoder``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from skinjax_torch.models.backbones import cnn_zoo, create_backbone
from skinjax_torch.models.fusion.blocks import MetaBlock, MetaNet, layer_norm
from skinjax_torch.models.fusion.multimodal import autocast_to


class MDNet(nn.Module):
    def __init__(self, num_classes: int = 6, meta_dim: int = 85, hidden_dim: int = 128,
                 cnn_model_name: str = "densenet169", dtype: Optional[torch.dtype] = None, *,
                 device=None):
        super().__init__()
        tower, channels = create_backbone(cnn_model_name, device=device)
        if not isinstance(tower, cnn_zoo.DenseNet):
            raise ValueError(f"MDNet takes a DenseNet tower; got {cnn_model_name!r}")
        self.dtype = dtype
        self.vocab_size = meta_dim
        self.feature_extractor = tower.features
        self.meta_net = MetaNet(meta_dim, hidden_dim, channels, device=device)
        self.meta_block = MetaBlock(meta_dim, channels, device=device)
        self.classifier = nn.Linear(channels, num_classes, device=device)

    def forward(self, image: torch.Tensor, metadata: torch.Tensor, *, capture: bool = False):
        with autocast_to(self.dtype, image.device):
            # the DenseNet tower's forward: features, then ReLU, as NHWC
            feat = torch.relu(self.feature_extractor(image.permute(0, 3, 1, 2)))
            feat = feat.permute(0, 2, 3, 1)
            fused = self.meta_net(feat, metadata) + self.meta_block(feat, metadata)
            pooled = fused.mean(dim=(1, 2))
            logits = self.classifier(pooled)
        return (logits, {"feature_map": fused, "img_feat": pooled}) if capture else logits


class LiwTERM(nn.Module):
    def __init__(self, num_classes: int, meta_dim: int,
                 image_encoder: str = "vit_large_patch16_224", dropout_rate: float = 0.3,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.vocab_size = meta_dim
        self.backbone, feat_dim = create_backbone(image_encoder, device=device)
        self.visual_proj = nn.Linear(feat_dim, 4096, device=device)
        self.visual_norm = layer_norm(4096, device=device)
        self.meta_norm = layer_norm(meta_dim, device=device)
        self.meta_fc = nn.Linear(meta_dim, 1024, device=device)
        self.slm_norm0 = layer_norm(4096 + 1024, device=device)
        widths = (4096 + 1024, 2048, 1024, 512)
        for i in range(3):
            self.add_module(f"slm_fc{i}", nn.Linear(widths[i], widths[i + 1], device=device))
            self.add_module(f"slm_norm{i + 1}", layer_norm(widths[i + 1], device=device))
        self.slm_out = nn.Linear(512, num_classes, device=device)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, image: torch.Tensor, metadata: torch.Tensor, *, capture: bool = False):
        with autocast_to(self.dtype, image.device):
            v = self.backbone(image)
            if v.dim() == 3:
                v = v[:, 0]  # the CLS token
            elif v.dim() == 4:
                v = v.mean(dim=(1, 2))
            aux = {"img_feat": v}
            v = self.dropout(torch.relu(self.visual_norm(self.visual_proj(v))))
            m = torch.relu(self.meta_fc(self.meta_norm(metadata)))
            x = torch.cat([v, m.to(v.dtype)], dim=-1)
            x = self.dropout(torch.relu(self.slm_norm0(x)))
            for i in range(3):
                x = getattr(self, f"slm_fc{i}")(x)
                x = self.dropout(torch.relu(getattr(self, f"slm_norm{i + 1}")(x)))
            logits = self.slm_out(x)
        return (logits, aux) if capture else logits


class MetaNetModel(nn.Module):
    def __init__(self, num_classes: int = 6, meta_dim: int = 85,
                 image_encoder: str = "resnet-50", dropout_rate: float = 0.3,
                 dtype: Optional[torch.dtype] = None, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.vocab_size = meta_dim
        self.backbone, feat_dim = create_backbone(image_encoder, device=device)
        self.metanet = MetaNet(meta_dim, 128, feat_dim, device=device)
        self.fc1 = nn.Linear(feat_dim, feat_dim, device=device)
        self.norm1 = layer_norm(feat_dim, device=device)
        self.fc2 = nn.Linear(feat_dim, feat_dim // 2, device=device)
        self.norm2 = layer_norm(feat_dim // 2, device=device)
        self.fc_out = nn.Linear(feat_dim // 2, num_classes, device=device)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, image: torch.Tensor, metadata: torch.Tensor, *, capture: bool = False):
        with autocast_to(self.dtype, image.device):
            feat = self.metanet(self.backbone(image), metadata)
            pooled = feat.mean(dim=(1, 2))
            x = self.dropout(torch.relu(self.norm1(self.fc1(pooled))))
            x = self.dropout(torch.relu(self.norm2(self.fc2(x))))
            logits = self.fc_out(x)
        return (logits, {"feature_map": feat, "img_feat": pooled}) if capture else logits
