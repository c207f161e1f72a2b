"""ResNet-18/50 image encoders (counterpart of
``skinjax/models/backbones/resnet.py``).

torchvision topology and parameter names (``conv1``, ``bn1``,
``layerL.B.convN``/``bnN``, ``layerL.B.downsample.0|1``): stem 7×7/2 pad 3,
max-pool 3/2 pad 1, stride on the bottleneck's 3×3 conv, BatchNorm with eps
1e-5: running statistics in eval mode, batch statistics in train mode, with
flax's running-variance update (``ops.batch_norm.BatchNorm2d``).

Input and output are NHWC, as in the JAX package; inside, the NCHW view of
an NHWC tensor is exactly PyTorch's ``channels_last`` layout, which cuDNN
runs without transposes. ``forward`` returns the pre-pooling map
(B, H', W', C): the multimodal model pools it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from skinjax_torch.ops.batch_norm import BatchNorm2d

FEATURE_DIMS = {"resnet-18": 512, "resnet-50": 2048}


def _conv(cin: int, cout: int, k: int, stride: int = 1, *, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, device=device)


def _bn(c: int, *, device=None) -> nn.BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, device=device)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, *, device=None):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride, device=device)
        self.bn1 = _bn(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, device=device)
        self.bn2 = _bn(planes, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                _conv(cin, planes, 1, stride, device=device), _bn(planes, device=device)
            )

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return self.relu(y + shortcut)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, *, device=None):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1, device=device)
        self.bn1 = _bn(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, stride, device=device)
        self.bn2 = _bn(planes, device=device)
        self.conv3 = _conv(planes, cout, 1, device=device)
        self.bn3 = _bn(cout, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                _conv(cin, cout, 1, stride, device=device), _bn(cout, device=device)
            )

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return self.relu(y + shortcut)


class ResNet(nn.Module):
    """Feature-extractor ResNet; ``stage_sizes`` and ``block`` select the variant."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "basic", width: int = 64,
                 *, device=None):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = _bn(width, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            planes = width * 2**i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(cin, planes, stride, device=device))
                cin = planes * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC → (B, H/32, W/32, C) NHWC."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last strides
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.permute(0, 2, 3, 1)


def resnet18(*, device=None) -> ResNet:
    return ResNet((2, 2, 2, 2), "basic", device=device)


def resnet50(*, device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), "bottleneck", device=device)
