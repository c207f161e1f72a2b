"""Swin, timm's ``swin_tiny_patch4_window7_224`` layout (counterpart of
``skinjax/models/backbones/transformer_zoo.py``'s ``Swin``).

patch embedding (conv 4×4/4 → LayerNorm) → 4 stages of Swin blocks, each
stage after the first opening with a patch merge (2×2 slice-concat →
LayerNorm(4C) → Linear(4C → 2C), no bias) → LayerNorm → global average pool.
A block: LayerNorm → (every odd block, where one window does not cover the
map: roll by −window/2) → window attention with the relative-position bias
(and the shifted-window mask) → roll back → +res → LayerNorm → MLP (exact
GELU) → +res. Parameter names are timm's ``state_dict`` keys, which
``skinjax.models.torch_import.import_swin`` reads: ``patch_embed.{proj,norm}``,
``layers.{i}.downsample.{norm,reduction}``, ``layers.{i}.blocks.{j}.{norm1,
attn.qkv, attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1,
mlp.fc2}``, ``norm`` (created last, so the freeze policy's "last layer" is the
final norm, as in skinjax). The relative-position index is a non-persistent
buffer, a copy of skinjax's static map.

The window attention takes one of skinjax's three routes:

- ``strip_attn=True`` (the default, skinjax's route on the TPU): K7 on the
  NHWC map (``ops/window_attention.window_attention_nhwc``), the bias and
  the shifted-window mask added in the kernel, no window partition;
- ``fused_attn=True, strip_attn=False``: K7's padded-window entry
  (``ops/window_attention.window_attention``) on partitioned windows, its
  backward the recompute core with the window mask;
- both False: the plain einsum on partitioned windows, as skinjax's XLA
  route computes it (q·kᵀ summed in fp32, then divided by √hd).

Input is NHWC ``(B, H, W, 3)`` with H/4 and W/4, and each stage's map,
multiples of the window; output ``(B, dims[-1])``, the mean over the map of
the final LayerNorm's output, which is what skinjax's multimodal model takes
from its ``(B, H, W, C)`` map. CAM (``capture``/``feature_delta``,
``backbones/capture.py``): the grid is that normed map, before the mean,
where skinjax's multimodal model adds the delta. Precision as in ``davit.py``: under autocast
the residual stream is fp32, and the attention takes x and its weights cast
to the autocast dtype, the bias and mask in fp32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.ops import compute_dtype, weight_t
from skinjax_torch.ops.window_attention import (
    window_attention,
    window_attention_nhwc,
    window_partition,
    window_reverse,
)

FEATURE_DIM = 768


def _ln(dim: int, *, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5, device=device)


def relative_position_index(w: int) -> np.ndarray:
    """timm's (N, N) index into the ((2w − 1)², heads) bias table, N = w²."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + w - 1) * (2 * w - 1) + (rel[1] + w - 1)


@lru_cache(maxsize=None)
def swin_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """The static additive mask of the shifted windows, (nW, N, N): −100
    between tokens that came from different regions of the rolled map (a
    copy of skinjax's ``_swin_attn_mask``)."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, H // w, w, W // w, w, 1).transpose(0, 1, 3, 2, 4, 5).reshape(-1, w * w)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def _device_mask(H: int, W: int, w: int, shift: int, device: torch.device) -> torch.Tensor:
    """``swin_attn_mask`` on ``device``, copied there once (a normal tensor
    even when first asked for under inference mode, so that training can
    use it too)."""
    with torch.inference_mode(False):
        return torch.as_tensor(swin_attn_mask(H, W, w, shift), device=device)


class WindowAttention(nn.Module):
    """Window MHA with the relative-position bias, on the NHWC map."""

    def __init__(self, dim: int, num_heads: int, window: int, fused_attn: bool = False,
                 strip_attn: bool = True, *, device=None):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.fused_attn, self.strip_attn = fused_attn, strip_attn
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads, device=device))
        self.register_buffer("relative_position_index", torch.as_tensor(
            relative_position_index(window), device=device), persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """(h, N, N) fp32, gathered from the table."""
        N = self.window ** 2
        idx = self.relative_position_index.reshape(-1)
        return self.relative_position_bias_table.float()[idx].reshape(N, N, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, H, W, C); mask (nW, N, N) fp32 or None."""
        H, W = x.shape[1:3]
        w = self.window
        bias = self.rel_bias().contiguous()
        if self.strip_attn:
            dt = compute_dtype(x)
            return window_attention_nhwc(
                x.to(dt).contiguous(), weight_t(self.qkv.weight, dt),
                self.qkv.bias.to(dt), weight_t(self.proj.weight, dt),
                self.proj.bias.to(dt), bias, mask, self.num_heads, w)
        xw = window_partition(x, w)
        if self.fused_attn:
            dt = compute_dtype(x)
            y = window_attention(
                xw.to(dt).contiguous(), weight_t(self.qkv.weight, dt),
                self.qkv.bias.to(dt), weight_t(self.proj.weight, dt),
                self.proj.bias.to(dt), bias, mask, self.num_heads)
        else:
            y = self._plain(xw, bias, mask)
        return window_reverse(y, w, H, W)

    def _plain(self, x, bias, mask):
        """skinjax's XLA route on windows x (nB, N, C)."""
        nB, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x)
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(nB, N, h, hd) for i in range(3))
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / hd ** 0.5 + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(nB // nW, nW, h, N, N) + mask[None, :, None]).reshape(nB, h, N, N)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(nB, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0, *, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, int(dim * ratio), device=device)
        self.fc2 = nn.Linear(int(dim * ratio), dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int = 7, shift: int = 0,
                 fused_attn: bool = False, strip_attn: bool = True, *, device=None):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = _ln(dim, device=device)
        self.attn = WindowAttention(dim, num_heads, window, fused_attn, strip_attn, device=device)
        self.norm2 = _ln(dim, device=device)
        self.mlp = Mlp(dim, device=device)

    def forward(self, x):
        B, H, W, C = x.shape
        w = self.window
        if H % w or W % w:
            raise ValueError(f"Swin's window attention needs H and W multiples of the window "
                             f"{w}; got a {H}x{W} map")
        # timm: no shift when one window covers the whole map
        shift = self.shift if (H > w or W > w) else 0
        y = self.norm1(x)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _device_mask(H, W, w, shift, x.device)
        y = self.attn(y, mask)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerge(nn.Module):
    """2×2 slice-concat → LayerNorm(4C) → Linear(4C → out, no bias)."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.norm = _ln(4 * in_dim, device=device)
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False, device=device)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int = 4, *, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, device=device)
        self.norm = _ln(dim, device=device)

    def forward(self, x):
        return self.norm(self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, num_heads: int, window: int,
                 downsample: bool, fused_attn: bool, strip_attn: bool, *, device=None):
        super().__init__()
        if downsample:
            self.downsample = PatchMerge(in_dim, dim, device=device)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, window // 2 if j % 2 else 0, fused_attn,
                      strip_attn, device=device)
            for j in range(depth))

    def forward(self, x):
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class Swin(nn.Module):
    """timm ``swin_tiny_patch4_window7_224`` topology by default; x (B, H, W,
    3) NHWC → (B, dims[-1])."""

    def __init__(self, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 6, 2), heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 7, fused_attn: bool = False, strip_attn: bool = True, *,
                 device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(dims[0], device=device)
        self.layers = nn.ModuleList(
            SwinStage(dims[max(i - 1, 0)], dims[i], depths[i], heads[i], window, i > 0,
                      fused_attn, strip_attn, device=device)
            for i in range(len(dims)))
        self.norm = _ln(dims[-1], device=device)

    def forward(self, x, capture: bool = False, feature_delta=None):
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        x = add_delta(self.norm(x), feature_delta)
        return (x.mean(dim=(1, 2)), x) if capture else x.mean(dim=(1, 2))


def swin_tiny(*, fused_attn: bool = False, strip_attn: bool = True, device=None) -> Swin:
    return Swin(fused_attn=fused_attn, strip_attn=strip_attn, device=device)
