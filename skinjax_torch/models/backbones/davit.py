"""DaViT, the timm-layout dual-attention vision transformer (counterpart of
``skinjax/models/backbones/davit.py``).

stem (conv 7×7/4 → LayerNorm) → 4 stages of (SpatialBlock, ChannelBlock)
pairs, each stage after the first opening with a Downsample (LayerNorm → conv
2×2/2) → global average pool → head LayerNorm. Parameter names are timm's
``state_dict`` keys, which ``skinjax.models.torch_import.import_davit``
reads: ``stem.{conv,norm}``, ``stages.{i}.downsample.{norm,conv}``,
``stages.{i}.blocks.{j}.{0,1}.{cpe1.proj,norm1,attn.qkv,attn.proj,cpe2.proj,
norm2,mlp.fc1,mlp.fc2}``, ``head.norm`` (created last, so the freeze policy's
"last layer" is the head norm, as in skinjax).

It runs what skinjax runs by default on the TPU: the depthwise-conv
positional encoding, window attention through the K7 kernel pair
(``ops/window_attention.py``, NHWC in and out, no window partition), and
plain channel attention and MLP. skinjax's ``ch_fused_attn`` sends the channel
attention through K8 (``ops/channel_attention.py``, forward and backward); as
in skinjax it is off unless asked for, and where the attribute is None the
environment asks (``SKINJAX_CHATTN=pallas``, read at each forward), so that
``run_service`` and the train CLI reach K8 with skinjax's knob. skinjax's
VMEM gate, which sends stage 0 to XLA, is a TPU limit and is left out. Input is NHWC ``(B, H, W, 3)``; output is
``LN(GAP(map))``, ``(B, dims[-1])``. A map whose H or W is not a multiple of
the window raises ``ValueError``. CAM (``capture``/``feature_delta``,
``backbones/capture.py``): the grid is the last stage's map, before the
pool and the head norm, as in skinjax.

Precision: under autocast (the multimodal model's ``dtype``) convolutions,
linears and the attention run in the autocast dtype, LayerNorm returns fp32
and the residual adds widen, so the residual stream is fp32. (skinjax's bf16
modules keep the stream in bf16.) The window attention takes x and its
weights cast to the autocast dtype, as skinjax's module casts them to its
dtype, and returns that dtype.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.ops import compute_dtype, weight_t
from skinjax_torch.ops.channel_attention import channel_attention
from skinjax_torch.ops.window_attention import window_attention_nhwc

FEATURE_DIM = 768


def _ln(dim: int, *, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5, device=device)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on an NHWC map: its NCHW view has channels_last strides."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvPosEnc(nn.Module):
    """Depthwise 3×3 convolution added residually (timm ConvPosEnc, no act)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, device=device)

    def forward(self, x):
        return x + _conv_nhwc(self.proj, x)


class DaViTWindowAttention(nn.Module):
    """Window MHA without relative bias on the NHWC map, through K7."""

    def __init__(self, dim: int, num_heads: int, window: int, *, device=None):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        dt = compute_dtype(x)
        return window_attention_nhwc(
            x.to(dt).contiguous(), weight_t(self.qkv.weight, dt), self.qkv.bias.to(dt),
            weight_t(self.proj.weight, dt), self.proj.bias.to(dt), None, None,
            self.num_heads, self.window)


class DaViTChannelAttention(nn.Module):
    """timm ChannelAttention: scaled keys, (hd × hd) token-aggregated
    attention, output re-expanded through the queries. ``fused``: skinjax's
    ``ch_fused_attn`` (None: ``SKINJAX_CHATTN=pallas`` decides)."""

    def __init__(self, dim: int, num_heads: int, fused: Optional[bool] = None, *, device=None):
        super().__init__()
        self.num_heads, self.fused = num_heads, fused
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        fused = self.fused
        if fused is None:
            fused = os.environ.get("SKINJAX_CHATTN", "") == "pallas"
        if fused:
            dt = compute_dtype(x)
            return channel_attention(
                x.to(dt).contiguous(), weight_t(self.qkv.weight, dt),
                self.qkv.bias.to(dt), weight_t(self.proj.weight, dt),
                self.proj.bias.to(dt), self.num_heads)
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x)
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, h, hd) for i in range(3))
        # attn[c, d] = Σ_n (k·scale)[n, c] v[n, d], summed in fp32
        attn = torch.einsum("bnhc,bnhd->bhcd", (k * hd ** -0.5).float(), v.float())
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        # out[n, c] = Σ_d attn[c, d] q[n, d]
        out = torch.einsum("bhcd,bnhd->bnhc", attn, q)
        return self.proj(out.reshape(B, N, C))


class DaViTMlp(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0, *, device=None):
        super().__init__()
        hidden = int(dim * ratio)
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SpatialBlock(nn.Module):
    """cpe1 → LN → window attention → +res → cpe2 → LN → MLP → +res."""

    def __init__(self, dim: int, num_heads: int, window: int = 7, *, device=None):
        super().__init__()
        self.window = window
        self.cpe1 = ConvPosEnc(dim, device=device)
        self.norm1 = _ln(dim, device=device)
        self.attn = DaViTWindowAttention(dim, num_heads, window, device=device)
        self.cpe2 = ConvPosEnc(dim, device=device)
        self.norm2 = _ln(dim, device=device)
        self.mlp = DaViTMlp(dim, device=device)

    def forward(self, x):
        H, W = x.shape[1:3]
        if H % self.window or W % self.window:
            raise ValueError(f"DaViT's window attention needs H and W multiples of the window "
                             f"{self.window}; got a {H}x{W} map")
        x = self.cpe1(x)
        x = x + self.attn(self.norm1(x))
        x = self.cpe2(x)
        return x + self.mlp(self.norm2(x))


class ChannelBlock(nn.Module):
    """cpe1 → LN → channel attention over the H·W tokens → +res → cpe2 → LN →
    MLP → +res."""

    def __init__(self, dim: int, num_heads: int, fused: Optional[bool] = None, *, device=None):
        super().__init__()
        self.cpe1 = ConvPosEnc(dim, device=device)
        self.norm1 = _ln(dim, device=device)
        self.attn = DaViTChannelAttention(dim, num_heads, fused, device=device)
        self.cpe2 = ConvPosEnc(dim, device=device)
        self.norm2 = _ln(dim, device=device)
        self.mlp = DaViTMlp(dim, device=device)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.cpe1(x)
        t = x.reshape(B, H * W, C)
        x = (t + self.attn(self.norm1(t))).reshape(B, H, W, C)
        x = self.cpe2(x)
        return x + self.mlp(self.norm2(x))


class DaViTDownsample(nn.Module):
    """LayerNorm(in) → conv 2×2 stride 2."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.norm = _ln(in_dim, device=device)
        self.conv = nn.Conv2d(in_dim, out_dim, 2, stride=2, device=device)

    def forward(self, x):
        return _conv_nhwc(self.conv, self.norm(x))


class DaViTStem(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.conv = nn.Conv2d(3, dim, 7, stride=4, padding=3, device=device)
        self.norm = _ln(dim, device=device)

    def forward(self, x):
        return self.norm(_conv_nhwc(self.conv, x))


class DaViTStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, num_heads: int, window: int,
                 downsample: bool, ch_fused_attn: Optional[bool] = None, *, device=None):
        super().__init__()
        if downsample:
            self.downsample = DaViTDownsample(in_dim, dim, device=device)
        self.blocks = nn.ModuleList(
            nn.Sequential(SpatialBlock(dim, num_heads, window, device=device),
                          ChannelBlock(dim, num_heads, ch_fused_attn, device=device))
            for _ in range(depth))

    def forward(self, x):
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class DaViTHead(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.norm = _ln(dim, device=device)

    def forward(self, x):
        return self.norm(x.mean(dim=(1, 2)))


class DaViT(nn.Module):
    """timm ``davit_tiny`` topology by default; x (B, H, W, 3) NHWC →
    (B, dims[-1])."""

    def __init__(self, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (1, 1, 3, 1), heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 7, ch_fused_attn: Optional[bool] = None, *, device=None):
        super().__init__()
        self.stem = DaViTStem(dims[0], device=device)
        self.stages = nn.ModuleList(
            DaViTStage(dims[max(i - 1, 0)], dims[i], depths[i], heads[i], window, i > 0,
                       ch_fused_attn, device=device)
            for i in range(len(dims)))
        self.head = DaViTHead(dims[-1], device=device)

    def forward(self, x, capture: bool = False, feature_delta=None):
        x = self.stem(x)
        for stage in self.stages:
            x = stage(x)
        x = add_delta(x, feature_delta)
        return (self.head(x), x) if capture else self.head(x)


def davit_tiny(*, ch_fused_attn: Optional[bool] = None, device=None) -> DaViT:
    return DaViT(ch_fused_attn=ch_fused_attn, device=device)
