"""CoaT-lite, timm's ``coat.py`` layout, serial blocks only (counterpart of
``skinjax/models/backbones/coat.py``).

Per stage: patch embedding (conv 4×4/4, then 2×2/2; LayerNorm over the
tokens) → a cls token in front → serial blocks → the image tokens back to a
map for the next stage; LayerNorm ``norm4`` on the last stage's tokens; the
output is its cls token. Parameter names are timm's ``state_dict`` keys,
which ``skinjax.models.torch_import.import_coat`` reads:
``patch_embed{k}.{proj,norm}``, ``cls_token{k}``, ``cpe{k}.proj``,
``crpe{k}.conv_list.{i}``, ``serial_blocks{k}.{j}.{norm1,
factoratt_crpe.{qkv,proj}, norm2, mlp.{fc1,fc2}}``, ``norm4`` (created last,
so the freeze policy's "last layer" is ``norm4``, as in skinjax).

The stage's convolutional position encoding (``cpe{k}``: depthwise 3×3 on the
image tokens, residual) and relative position encoding (``crpe{k}``:
depthwise 3/5/7 windows over 2/3/3 heads of v, gated by q) are shared by the
stage's blocks, and the port holds one copy of each at the model level.
timm's blocks hold references to them, so timm's own ``state_dict()`` repeats
them under ``serial_blocks{k}.{j}.cpe`` and ``….factoratt_crpe.crpe``;
``import_coat`` reads only the model-level keys, and those are the port's
keys. What skinjax's module computes, carried over exactly: factorized
attention (the softmax of k over the tokens in fp32, its ``kᵀv`` factor cast
to the compute dtype, ``q·factor·Ch^-0.5 + crpe``), LayerNorms at eps 1e-6,
and the serial MLP (fc1 → exact GELU → fc2) as one call of the fused K9
kernel (``ops/fused_mlp.mlp_gelu``) on every block. Input is NHWC ``(B, H, W,
3)``; output ``(B, dims[-1])``. CAM (``capture``/``feature_delta``,
``backbones/capture.py``): the grid is the last stage's image tokens entering
its last serial block, as in skinjax (the cls token read out after it mixes
them there), so a CAM's gradient goes back through that block's K9.

Precision: under autocast (the multimodal model's ``dtype``) convolutions
and linears run in the autocast dtype, LayerNorm returns fp32 and the
residual adds widen, so the residual stream is fp32 (skinjax's bf16 modules
keep it in bf16). The attention works in the qkv projection's dtype; the MLP
casts its input, weights and biases to the autocast dtype, as skinjax's
``promote_dtype`` does, so K9 runs in bf16 there.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.models.backbones.davit import _conv_nhwc
from skinjax_torch.models.backbones.vit import layer_norm
from skinjax_torch.ops import compute_dtype
from skinjax_torch.ops.fused_mlp import mlp_gelu

FEATURE_DIM = 512
CRPE_WINDOWS = ((3, 2), (5, 3), (7, 3))  # (kernel, heads)


class ConvPosEnc(nn.Module):
    """Depthwise 3×3 over the image tokens, residual; the cls token passes."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, device=device)

    def forward(self, x, hw: Tuple[int, int]):
        B, N, C = x.shape
        feat = x[:, 1:].reshape(B, *hw, C)
        feat = feat + _conv_nhwc(self.proj, feat)
        return torch.cat([x[:, :1], feat.reshape(B, N - 1, C)], dim=1)


class ConvRelPosEnc(nn.Module):
    """Multi-window depthwise convs over v, gated by q; zero for the cls
    token. ``windows``: ((kernel, heads), ...)."""

    def __init__(self, head_dim: int, windows=CRPE_WINDOWS, *, device=None):
        super().__init__()
        self.splits = [heads * head_dim for _, heads in windows]
        self.conv_list = nn.ModuleList(
            nn.Conv2d(ch, ch, k, padding=k // 2, groups=ch, device=device)
            for (k, _), ch in zip(windows, self.splits))

    def forward(self, q, v, hw: Tuple[int, int]):
        B, h, N, Ch = q.shape
        # (B, h, HW, Ch) → (B, H, W, h·Ch), head-major channels
        v_map = v[:, :, 1:].transpose(1, 2).reshape(B, *hw, h * Ch)
        conv_v = torch.cat([_conv_nhwc(conv, seg) for conv, seg in
                            zip(self.conv_list, torch.split(v_map, self.splits, dim=-1))], dim=-1)
        ev = q[:, :, 1:] * conv_v.reshape(B, N - 1, h, Ch).transpose(1, 2)
        return torch.cat([ev.new_zeros(B, h, 1, Ch), ev], dim=2)


class FactorAttnConvRelPosEnc(nn.Module):
    """qkv → factorized attention + the stage's crpe → proj."""

    def __init__(self, dim: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, crpe: ConvRelPosEnc, hw: Tuple[int, int]):
        B, N, C = x.shape
        h = self.num_heads
        Ch = C // h
        qkv = self.qkv(x)
        dt = qkv.dtype
        # timm's unit order [q|k|v][head][Ch]
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, h, Ch).transpose(1, 2)
                   for i in range(3))
        with torch.autocast(x.device.type, enabled=False):
            k_soft = torch.softmax(k.float(), dim=2).to(dt)
            factor = (k_soft.float().transpose(-1, -2) @ v.float()).to(dt)
            fa = q @ factor
        out = Ch ** -0.5 * fa + crpe(q, v, hw)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class SerialMlp(nn.Module):
    """fc1 → exact GELU → fc2, as one K9 call."""

    def __init__(self, dim: int, hidden: int, *, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        dt = compute_dtype(x)
        return mlp_gelu(x.to(dt), self.fc1.weight.t().to(dt), self.fc1.bias.to(dt),
                        self.fc2.weight.t().to(dt), self.fc2.bias.to(dt))


class SerialBlock(nn.Module):
    """cpe → norm1 → factorized attention (+crpe) → +res → norm2 → MLP → +res;
    the stage's cpe and crpe are passed in."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, *, device=None):
        super().__init__()
        self.norm1 = layer_norm(dim, device=device)
        self.factoratt_crpe = FactorAttnConvRelPosEnc(dim, num_heads, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = SerialMlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x, cpe: ConvPosEnc, crpe: ConvRelPosEnc, hw: Tuple[int, int]):
        x = cpe(x, hw)
        x = x + self.factoratt_crpe(self.norm1(x), crpe, hw)
        return x + self.mlp(self.norm2(x))


class CoaTLite(nn.Module):
    """timm's coat-lite topology; ``coat_lite_small`` by default. x (B, H, W,
    3) NHWC → the normed last-stage cls token, (B, dims[-1])."""

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512),
                 depths: Sequence[int] = (3, 4, 6, 3), heads: int = 8,
                 mlp_ratios: Sequence[float] = (8.0, 8.0, 4.0, 4.0), crpe_windows=CRPE_WINDOWS,
                 *, device=None):
        super().__init__()
        self.num_stages = len(dims)
        for si, dim in enumerate(dims):
            pe = nn.Module()
            k = 4 if si == 0 else 2
            pe.proj = nn.Conv2d(3 if si == 0 else dims[si - 1], dim, k, stride=k, device=device)
            pe.norm = layer_norm(dim, device=device)
            setattr(self, f"patch_embed{si + 1}", pe)
        for si, dim in enumerate(dims):
            setattr(self, f"cls_token{si + 1}", nn.Parameter(torch.zeros(1, 1, dim, device=device)))
        for si, dim in enumerate(dims):
            setattr(self, f"cpe{si + 1}", ConvPosEnc(dim, device=device))
        for si, dim in enumerate(dims):
            setattr(self, f"crpe{si + 1}", ConvRelPosEnc(dim // heads, crpe_windows, device=device))
        for si, (dim, depth, ratio) in enumerate(zip(dims, depths, mlp_ratios)):
            setattr(self, f"serial_blocks{si + 1}", nn.ModuleList(
                SerialBlock(dim, heads, ratio, device=device) for _ in range(depth)))
        self.norm4 = layer_norm(dims[-1], device=device)

    def forward(self, x, capture: bool = False, feature_delta=None):
        B = x.shape[0]
        cam = capture or feature_delta is not None
        fmap = None
        for k in range(1, self.num_stages + 1):
            pe = getattr(self, f"patch_embed{k}")
            x = _conv_nhwc(pe.proj, x)
            hw = tuple(x.shape[1:3])
            x = pe.norm(x.reshape(B, hw[0] * hw[1], -1))
            cls = getattr(self, f"cls_token{k}")
            x = torch.cat([cls.to(x.dtype).expand(B, 1, -1), x], dim=1)
            cpe, crpe = getattr(self, f"cpe{k}"), getattr(self, f"crpe{k}")
            blocks = getattr(self, f"serial_blocks{k}")
            for bi, block in enumerate(blocks):
                if cam and k == self.num_stages and bi == len(blocks) - 1:
                    fmap = add_delta(x[:, 1:].reshape(B, *hw, -1), feature_delta)
                    x = torch.cat([x[:, :1], fmap.reshape(B, hw[0] * hw[1], -1)], dim=1)
                x = block(x, cpe, crpe, hw)
            if k < self.num_stages:
                x = x[:, 1:].reshape(B, *hw, -1)  # drop cls for the next stage
        pooled = self.norm4(x)[:, 0]
        return (pooled, fmap) if capture else pooled


def coat_lite_small(*, device=None) -> CoaTLite:
    return CoaTLite(device=device)
