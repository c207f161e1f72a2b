"""CAFormer, timm's ``metaformer.py`` layout (counterpart of
``skinjax/models/backbones/caformer.py``).

stem (conv 7×7/4 pad 2 → bias-free LayerNorm) → 4 stages of MetaFormer
blocks, each stage after the first opening with a downsample (bias-free
LayerNorm → conv 3×3/2 pad 1) → global average pool → head LayerNorm (with
bias), what timm's ``reset_classifier(0)`` keeps. Parameter names are timm's
``state_dict`` keys, which ``skinjax.models.torch_import.import_caformer``
reads: ``stem.{conv,norm}``, ``stages.{i}.downsample.{norm,conv}``,
``stages.{i}.blocks.{j}.{norm1, token_mixer.{pwconv1, act1.{scale,bias},
dwconv, pwconv2 | qkv, proj}, norm2, mlp.{fc1, act.{scale,bias}, fc2},
res_scale{1,2}.scale}``, ``head.norm`` (created last, so the freeze policy's
"last layer" is the head norm, as skinjax's ``head_norm`` is).

What skinjax's module computes, carried over exactly: StarReLU
(``s·relu(x)² + b``, learnable scalars) in the SepConv mixer (pwconv1 →
StarReLU → depthwise 7×7 → pwconv2, all bias-free) and in the MLPs;
bias-free block and downsample LayerNorms at eps 1e-6; global attention with
32 channels a head and bias-free qkv/proj on stages 3/4; residual scaling of
the identity branch on stages 3/4. Two kernels run every block they can: the
attention core is the K12 kernel pair (``ops/global_attention.py``, skinjax's
``SKINJAX_CAFORMER_ATTN=pallas`` route) and every MLP is the fused K10 kernel
(``ops/fused_mlp.mlp_star``). Input is NHWC ``(B, H, W, 3)``; output
``(B, dims[-1])``. CAM (``capture``/``feature_delta``,
``backbones/capture.py``): the grid is the last stage's map, before the pool
and the head norm, as in skinjax. skinjax's ``features`` is not ported.

Precision: under autocast (the multimodal model's ``dtype``) convolutions
and linears run in the autocast dtype, LayerNorm returns fp32 and the
residual adds widen, so the residual stream is fp32 (skinjax's bf16 modules
keep it in bf16). The MLP casts its input and weights to the autocast dtype,
as skinjax's ``promote_dtype`` does, and keeps StarReLU's scalars in fp32, so
K10 runs in bf16 there; the attention core takes the qkv projection's output
as it comes (bf16). K12 scales the fp32 scores by 32^-0.5, where skinjax's
default einsum scales q in its dtype: the two agree in fp32 and differ by
bf16 rounding in bf16.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.models.backbones.davit import _conv_nhwc
from skinjax_torch.ops import compute_dtype
from skinjax_torch.ops.fused_mlp import mlp_star
from skinjax_torch.ops.global_attention import attention_core

HEAD_DIM = 32


def _ln_nb(dim: int, *, device=None) -> nn.LayerNorm:
    """skinjax's bias-free LayerNorm (timm's LayerNormNoBias)."""
    return nn.LayerNorm(dim, eps=1e-6, bias=False, device=device)


class StarReLU(nn.Module):
    """s·relu(x)² + b with learnable scalars, in x's dtype."""

    def __init__(self, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1, device=device))
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x):
        r = F.relu(x)
        return self.scale.to(x.dtype) * r * r + self.bias.to(x.dtype)


class SepConvMixer(nn.Module):
    """pwconv1 → StarReLU → depthwise 7×7 → pwconv2, all bias-free."""

    def __init__(self, dim: int, expansion: float = 2.0, *, device=None):
        super().__init__()
        mid = int(dim * expansion)
        self.pwconv1 = nn.Linear(dim, mid, bias=False, device=device)
        self.act1 = StarReLU(device=device)
        self.dwconv = nn.Conv2d(mid, mid, 7, padding=3, groups=mid, bias=False, device=device)
        self.pwconv2 = nn.Linear(mid, dim, bias=False, device=device)

    def forward(self, x):
        return self.pwconv2(_conv_nhwc(self.dwconv, self.act1(self.pwconv1(x))))


class MetaFormerAttention(nn.Module):
    """Global MHA, 32 channels a head, bias-free qkv/proj, through K12."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.num_heads = max(1, dim // HEAD_DIM)
        att_dim = self.num_heads * HEAD_DIM
        self.qkv = nn.Linear(dim, 3 * att_dim, bias=False, device=device)
        self.proj = nn.Linear(att_dim, dim, bias=False, device=device)

    def forward(self, x):
        B, H, W, C = x.shape
        a = self.proj.in_features
        qkv = self.qkv(x.reshape(B, H * W, C))
        # timm's unit order [q|k|v][head][hd]: head-major slices
        out = attention_core(qkv[..., :a], qkv[..., a:2 * a], qkv[..., 2 * a:], None, None, None,
                             self.num_heads)
        return self.proj(out).reshape(B, H, W, C)


class MetaFormerMlp(nn.Module):
    """fc1 → StarReLU → fc2, bias-free, as one K10 call."""

    def __init__(self, dim: int, ratio: float = 4.0, *, device=None):
        super().__init__()
        hid = int(dim * ratio)
        self.fc1 = nn.Linear(dim, hid, bias=False, device=device)
        self.act = StarReLU(device=device)
        self.fc2 = nn.Linear(hid, dim, bias=False, device=device)

    def forward(self, x):
        dt = compute_dtype(x)
        return mlp_star(x.to(dt), self.fc1.weight.t().to(dt), self.act.scale, self.act.bias,
                        self.fc2.weight.t().to(dt))


class Scale(nn.Module):
    """timm's per-channel residual scale (``res_scale{1,2}.scale``)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return x * self.scale


class MetaFormerBlock(nn.Module):
    def __init__(self, dim: int, mixer: str, res_scale: bool = False, *, device=None):
        super().__init__()
        self.norm1 = _ln_nb(dim, device=device)
        self.token_mixer = (SepConvMixer(dim, device=device) if mixer == "conv"
                            else MetaFormerAttention(dim, device=device))
        self.norm2 = _ln_nb(dim, device=device)
        self.mlp = MetaFormerMlp(dim, device=device)
        if res_scale:
            self.res_scale1 = Scale(dim, device=device)
            self.res_scale2 = Scale(dim, device=device)

    def forward(self, x):
        scaled = hasattr(self, "res_scale1")
        x = (self.res_scale1(x) if scaled else x) + self.token_mixer(self.norm1(x))
        return (self.res_scale2(x) if scaled else x) + self.mlp(self.norm2(x))


class CAFormer(nn.Module):
    """timm's caformer topology: [SepConv, SepConv, Attention, Attention]
    mixers, res_scale on stages 3/4; ``caformer_s18`` by default. x (B, H, W,
    3) NHWC → head-LayerNorm(global-avg-pool), (B, dims[-1])."""

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 3, 9, 3),
                 mixers: Sequence[str] = ("conv", "conv", "attention", "attention"),
                 res_scale_stages: Sequence[bool] = (False, False, True, True), *, device=None):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = nn.Conv2d(3, dims[0], 7, stride=4, padding=2, device=device)
        self.stem.norm = _ln_nb(dims[0], device=device)
        self.stages = nn.ModuleList()
        for si, (dim, depth, mixer, rs) in enumerate(zip(dims, depths, mixers, res_scale_stages)):
            stage = nn.Module()
            if si > 0:
                stage.downsample = nn.Module()
                stage.downsample.norm = _ln_nb(dims[si - 1], device=device)
                stage.downsample.conv = nn.Conv2d(dims[si - 1], dim, 3, stride=2, padding=1,
                                                  device=device)
            stage.blocks = nn.ModuleList(MetaFormerBlock(dim, mixer, rs, device=device)
                                         for _ in range(depth))
            self.stages.append(stage)
        self.head = nn.Module()
        self.head.norm = nn.LayerNorm(dims[-1], eps=1e-6, device=device)

    def forward(self, x, capture: bool = False, feature_delta=None):
        x = self.stem.norm(_conv_nhwc(self.stem.conv, x))
        for stage in self.stages:
            if hasattr(stage, "downsample"):
                x = _conv_nhwc(stage.downsample.conv, stage.downsample.norm(x))
            for block in stage.blocks:
                x = block(x)
        x = add_delta(x, feature_delta)
        pooled = self.head.norm(x.mean(dim=(1, 2)))
        return (pooled, x) if capture else pooled


def caformer_s18(*, device=None) -> CAFormer:
    return CAFormer(device=device)


def caformer_b36(*, device=None) -> CAFormer:
    return CAFormer((128, 256, 512, 768), (3, 12, 18, 3), device=device)
