"""Backbone registry (counterpart of ``skinjax/models/backbones/__init__.py``).

``create_backbone(name)`` returns ``(module, feature_dim)``. Every backbone
of skinjax's registry is ported: the ResNets, DaViT-tiny, Swin-tiny, the four
ViTs, BEiT-v2-large, MViTv2-small, CAFormer-s18/b36, CoaT-lite-small,
NextViT-small and the CNN zoo (custom-cnn, VGG16, DenseNet-169, MobileNet-V2,
EfficientNet-B0/B7). custom-cnn's feature width is ``common_dim`` (its
entry's width is None), so ``create_backbone`` passes it on.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from torch import nn

from skinjax_torch.models.backbones import (
    beit,
    caformer,
    cnn_zoo,
    coat,
    davit,
    mvit,
    nextvit,
    resnet,
    swin,
    vit,
)

_REGISTRY: Dict[str, Tuple[Callable[..., nn.Module], Optional[int]]] = {
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
    "nextvit_small": (nextvit.nextvit_small, nextvit.FEATURE_DIM),
    "custom-cnn": (cnn_zoo.custom_cnn, None),
    "vgg16": (cnn_zoo.vgg16, cnn_zoo.FEATURE_DIMS["vgg16"]),
    "densenet169": (cnn_zoo.densenet169, cnn_zoo.FEATURE_DIMS["densenet169"]),
    "mobilenet-v2": (cnn_zoo.mobilenet_v2, cnn_zoo.FEATURE_DIMS["mobilenet-v2"]),
    "efficientnet-b0": (cnn_zoo.efficientnet_b0, cnn_zoo.FEATURE_DIMS["efficientnet-b0"]),
    "efficientnet-b7": (cnn_zoo.efficientnet_b7, cnn_zoo.FEATURE_DIMS["efficientnet-b7"]),
}


def create_backbone(name: str, *, device=None, common_dim: int = 512) -> Tuple[nn.Module, int]:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone '{name}' is not ported to PyTorch yet (ported: "
            f"{sorted(_REGISTRY)}); ROADMAP.md lists when each comes"
        )
    ctor, dim = _REGISTRY[name]
    if dim is None:
        return ctor(device=device, common_dim=common_dim), common_dim
    return ctor(device=device), dim
