"""The CNN zoo under torchvision's names: custom-cnn, VGG16, DenseNet-169,
MobileNet-V2, EfficientNet-B0/B7 (counterpart of
``skinjax/models/backbones/cnn_zoo.py``).

Parameter names are torchvision's ``state_dict`` keys, which
``skinjax.models.torch_import``'s ``import_vgg16``/``import_densenet``/
``import_mobilenet_v2``/``import_efficientnet`` read (custom-cnn, which has no
importer, as ``conv``/``fc``); the last parameter created is each tower's last
layer, as in skinjax (the freeze policy's "last layer"). The BatchNorms are
``ops.batch_norm.BatchNorm2d`` (flax's running variance; eps 1e-5, 1e-3 in
EfficientNet), so ``fuse_batch_norms`` sends them through K6.

Layout: input NHWC ``(B, H, W, 3)``; inside, NCHW views with channels_last
strides on the card (DenseNet's concatenations keep them). Output as
skinjax's: the pre-pooling NHWC map ``(B, H', W', C)`` for DenseNet,
MobileNet-V2 and EfficientNet; pooled features for custom-cnn
(``(B, common_dim)``) and VGG16 (``(B, 4096)``: classifier[:-1] kept, one
dropout 0.5 after fc1, the map flattened in (C, H, W) order with no adaptive
pool, so fc1 takes 512·7·7 features at 224×224 only).

Each tower's ``flax_scopes()`` lists (parameter-name prefix, skinjax scope)
pairs: the key map of ``state_dict_from_flax``, which the freeze policy reads
to apply skinjax's "partial" markers to skinjax's names.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Iterator, Sequence, Tuple

import torch
from torch import nn

from skinjax_torch.ops.batch_norm import BatchNorm2d

FEATURE_DIMS = {"vgg16": 4096, "densenet169": 1664, "mobilenet-v2": 1280,
                "efficientnet-b0": 1280, "efficientnet-b7": 2560}

Scopes = Iterator[Tuple[str, str]]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1, act=None,
             eps: float = 1e-5, *, device=None) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: conv (no bias, pad k//2) → BN
    → act: keys ``0`` and ``1``."""
    layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False,
                        device=device), BatchNorm2d(cout, eps=eps, device=device)]
    if act is not None:
        layers.append(act())
    return nn.Sequential(*layers)


class CustomCNN(nn.Module):
    """The reference's tiny custom-cnn: conv 3→16 (3×3/2, bias) → ReLU →
    max-pool 2 → mean over the map → Linear(common_dim)."""

    def __init__(self, common_dim: int = 512, *, device=None):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 3, stride=2, padding=1, device=device)
        self.fc = nn.Linear(16, common_dim, device=device)

    def forward(self, x):
        x = torch.relu(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(nn.functional.max_pool2d(x, 2, 2).mean(dim=(2, 3)))

    def flax_scopes(self) -> Scopes:
        yield from (("conv.", "conv"), ("fc.", "fc"))


VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512, "M")


class VGG16(nn.Module):
    """torchvision's VGG16 ``features`` (convs with bias, ReLU, max-pools at
    their indices) and ``classifier`` up to fc2's ReLU."""

    def __init__(self, cfg: Sequence = VGG16_CFG, flat: int = 512 * 7 * 7, *, device=None):
        super().__init__()
        layers, cin = [], 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1, device=device), nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(flat, 4096, device=device), nn.ReLU(inplace=True), nn.Dropout(0.5),
            nn.Linear(4096, 4096, device=device), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.classifier(self.features(x.permute(0, 3, 1, 2)).flatten(1))

    def flax_scopes(self) -> Scopes:
        convs = [i for i, m in enumerate(self.features) if isinstance(m, nn.Conv2d)]
        yield from ((f"features.{li}.", f"conv{i}") for i, li in enumerate(convs))
        yield from (("classifier.0.", "fc1"), ("classifier.3.", "fc2"))


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4, *, device=None):
        super().__init__()
        self.norm1 = BatchNorm2d(cin, device=device)
        self.conv1 = nn.Conv2d(cin, bn_size * growth_rate, 1, bias=False, device=device)
        self.norm2 = BatchNorm2d(bn_size * growth_rate, device=device)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False,
                               device=device)

    def forward(self, x):
        """x → the concatenation [x, new features]."""
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int, *, device=None):
        super().__init__()
        self.norm = BatchNorm2d(cin, device=device)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False, device=device)

    def forward(self, x):
        return nn.functional.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """torchvision's DenseNet ``features``; densenet169 = block_config
    (6, 12, 32, 32), 1664 channels out (ReLU'd, as skinjax's)."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 32, 32), growth_rate: int = 32,
                 init_features: int = 64, *, device=None):
        super().__init__()
        self.block_config = tuple(block_config)
        layers = [("conv0", nn.Conv2d(3, init_features, 7, stride=2, padding=3, bias=False,
                                      device=device)),
                  ("norm0", BatchNorm2d(init_features, device=device)),
                  ("relu0", nn.ReLU(inplace=True)),
                  ("pool0", nn.MaxPool2d(3, stride=2, padding=1))]
        c = init_features
        for i, n_layers in enumerate(block_config):
            block = []
            for j in range(n_layers):
                block.append((f"denselayer{j + 1}", DenseLayer(c, growth_rate, device=device)))
                c += growth_rate
            layers.append((f"denseblock{i + 1}", nn.Sequential(OrderedDict(block))))
            if i != len(block_config) - 1:
                layers.append((f"transition{i + 1}", Transition(c, c // 2, device=device)))
                c //= 2
        layers.append(("norm5", BatchNorm2d(c, device=device)))
        self.features = nn.Sequential(OrderedDict(layers))

    def forward(self, x):
        return _nhwc(torch.relu(self.features(x.permute(0, 3, 1, 2))))

    def flax_scopes(self) -> Scopes:
        yield from (("features.conv0.", "conv0"), ("features.norm0.", "norm0"))
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                yield f"features.denseblock{i + 1}.denselayer{j + 1}.", f"block{i}_layer{j}"
            if i != len(self.block_config) - 1:
                yield f"features.transition{i + 1}.norm.", f"trans{i}_norm"
                yield f"features.transition{i + 1}.conv.", f"trans{i}_conv"
        yield "features.norm5.", "norm_final"


class InvertedResidual(nn.Module):
    """torchvision's: ``conv`` = [expand ConvBNReLU6] → depthwise
    ConvBNReLU6 → project conv → BN; the residual where the shape stays."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int, *, device=None):
        super().__init__()
        hidden = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(cin, hidden, 1, act=nn.ReLU6, device=device))
        layers += [_conv_bn(hidden, hidden, 3, stride, groups=hidden, act=nn.ReLU6, device=device),
                   nn.Conv2d(hidden, cout, 1, bias=False, device=device),
                   BatchNorm2d(cout, device=device)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.residual else y


MOBILENET_V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2(nn.Module):
    """torchvision's MobileNetV2 ``features``: 1280 channels out."""

    def __init__(self, cfg: Sequence = MOBILENET_V2_CFG, *, device=None):
        super().__init__()
        layers = [_conv_bn(3, 32, 3, 2, act=nn.ReLU6, device=device)]
        cin = 32
        for t, c, n, s in cfg:
            for j in range(n):
                layers.append(InvertedResidual(cin, c, s if j == 0 else 1, t, device=device))
                cin = c
        layers.append(_conv_bn(cin, 1280, 1, act=nn.ReLU6, device=device))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return _nhwc(self.features(x.permute(0, 3, 1, 2)))

    def flax_scopes(self) -> Scopes:
        last = len(self.features) - 1
        yield from (("features.0.0.", "stem"), ("features.0.1.", "stem_bn"))
        yield from ((f"features.{i}.", f"block{i - 1}") for i in range(1, last))
        yield from ((f"features.{last}.0.", "head"), (f"features.{last}.1.", "head_bn"))


class SqueezeExcitation(nn.Module):
    """mean over the map → 1×1 conv (bias) → SiLU → 1×1 conv (bias) →
    sigmoid gate."""

    def __init__(self, channels: int, reduced: int, *, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, reduced, 1, device=device)
        self.fc2 = nn.Conv2d(reduced, channels, 1, device=device)

    def forward(self, x):
        s = self.fc2(nn.functional.silu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """torchvision's: ``block`` = [expand ConvBNSiLU] → depthwise ConvBNSiLU
    → SE (a quarter of the block's input channels) → project ConvBN; BN eps
    1e-3; the residual where the shape stays (no stochastic depth, as
    skinjax)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand_ratio: int,
                 *, device=None):
        super().__init__()
        hidden = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(cin, hidden, 1, act=nn.SiLU, eps=1e-3, device=device))
        layers += [_conv_bn(hidden, hidden, kernel, stride, groups=hidden, act=nn.SiLU, eps=1e-3,
                            device=device),
                   SqueezeExcitation(hidden, max(1, int(cin * 0.25)), device=device),
                   _conv_bn(hidden, cout, 1, eps=1e-3, device=device)]
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.block(x)
        return x + y if self.residual else y


def round_filters(f: int, width: float) -> int:
    f *= width
    new_f = max(8, int(f + 4) // 8 * 8)
    if new_f < 0.9 * f:
        new_f += 8
    return int(new_f)


EFFICIENTNET_CFG = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
                    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))


class EfficientNet(nn.Module):
    """torchvision's EfficientNet ``features``: a stem, one Sequential of
    MBConvs a stage, a head; B0 1280 channels out, B7 2560."""

    def __init__(self, width: float = 1.0, depth: float = 1.0, cfg: Sequence = EFFICIENTNET_CFG,
                 *, device=None):
        super().__init__()
        cin = round_filters(32, width)
        layers = [_conv_bn(3, cin, 3, 2, act=nn.SiLU, eps=1e-3, device=device)]
        for t, c, n, s, k in cfg:
            c = round_filters(c, width)
            stage = []
            for j in range(int(math.ceil(n * depth))):
                stage.append(MBConv(cin, c, k, s if j == 0 else 1, t, device=device))
                cin = c
            layers.append(nn.Sequential(*stage))
        layers.append(_conv_bn(cin, round_filters(1280, width), 1, act=nn.SiLU, eps=1e-3,
                               device=device))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        return _nhwc(self.features(x.permute(0, 3, 1, 2)))

    def flax_scopes(self) -> Scopes:
        last = len(self.features) - 1
        yield from (("features.0.0.", "stem"), ("features.0.1.", "stem_bn"))
        idx = 0
        for si in range(1, last):
            for b in range(len(self.features[si])):
                yield f"features.{si}.{b}.", f"block{idx}"
                idx += 1
        yield from ((f"features.{last}.0.", "head"), (f"features.{last}.1.", "head_bn"))


def custom_cnn(*, device=None, common_dim: int = 512) -> CustomCNN:
    return CustomCNN(common_dim, device=device)


def vgg16(*, device=None) -> VGG16:
    return VGG16(device=device)


def densenet169(*, device=None) -> DenseNet:
    return DenseNet((6, 12, 32, 32), device=device)


def mobilenet_v2(*, device=None) -> MobileNetV2:
    return MobileNetV2(device=device)


def efficientnet_b0(*, device=None) -> EfficientNet:
    return EfficientNet(1.0, 1.0, device=device)


def efficientnet_b7(*, device=None) -> EfficientNet:
    return EfficientNet(2.0, 3.1, device=device)
