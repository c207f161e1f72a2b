"""Backbone registry (counterpart of ``skinjax/models/backbones/__init__.py``).

``create_backbone(name)`` returns ``(module, feature_dim)``. The ResNets,
DaViT-tiny, Swin-tiny, the four ViTs, BEiT-v2-large, MViTv2-small,
CAFormer-s18/b36 and CoaT-lite-small are ported so far; ROADMAP.md
lists the other backbones in the order they come.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from torch import nn

from skinjax_torch.models.backbones import beit, caformer, coat, davit, mvit, resnet, swin, vit

_REGISTRY: Dict[str, Tuple[Callable[..., nn.Module], int]] = {
    "resnet-18": (resnet.resnet18, resnet.FEATURE_DIMS["resnet-18"]),
    "resnet-50": (resnet.resnet50, resnet.FEATURE_DIMS["resnet-50"]),
    "davit_tiny": (davit.davit_tiny, davit.FEATURE_DIM),
    "swin_tiny_patch4_window7_224": (swin.swin_tiny, swin.FEATURE_DIM),
    "vit_tiny_patch16_224": (vit.vit_tiny, 192),
    "vit_small_patch16_224": (vit.vit_small, 384),
    "vit_base_patch16_224": (vit.vit_base, 768),
    "vit_large_patch16_224": (vit.vit_large, 1024),
    "beitv2_large_patch16_224": (beit.beitv2_large, 1024),
    "mvitv2_small": (mvit.mvitv2_small, mvit.FEATURE_DIM),
    "caformer_b36": (caformer.caformer_b36, 768),
    "caformer_s18": (caformer.caformer_s18, 512),
    "coat_lite_small": (coat.coat_lite_small, coat.FEATURE_DIM),
}


def create_backbone(name: str, *, device=None) -> Tuple[nn.Module, int]:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone '{name}' is not ported to PyTorch yet (ported: "
            f"{sorted(_REGISTRY)}); ROADMAP.md lists when each comes"
        )
    ctor, dim = _REGISTRY[name]
    return ctor(device=device), dim
