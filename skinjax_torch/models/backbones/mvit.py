"""MViTv2, timm's ``mvitv2.py`` layout (counterpart of
``skinjax/models/backbones/mvit.py``).

patch embedding (conv 7×7/4 with bias) → 4 stages of MultiScaleBlocks →
LayerNorm → mean over the tokens. Parameter names are timm's ``state_dict``
keys, which ``skinjax.models.torch_import.import_mvit`` reads:
``patch_embed.proj``, ``stages.{i}.blocks.{j}.{norm1, shortcut_proj_attn,
attn.{qkv, pool_q, norm_q, pool_k, norm_k, pool_v, norm_v, rel_pos_h,
rel_pos_w, proj}, norm2, mlp.{fc1, fc2}}``, ``norm`` (created last, so the
freeze policy's "last layer" is the final norm, as in skinjax).

What skinjax's module computes, carried over exactly: the qkv projection
that expands the width at each stage's first block; per-head depthwise 3×3
pooling of q, k and v (one ``Conv2d(hd, hd, groups=hd)`` shared by the
heads), each followed by a LayerNorm over the head's channels; the query
stride 2 at each stage transition and the adaptive key/value stride 4 → 2 →
1 → 1; the decomposed relative-position bias, ``bias_h``/``bias_w`` from the
pooled q and the ``rel_pos_h``/``rel_pos_w`` rows its distance maps gather;
the attention core through the K11 kernel pair
(``ops/pooled_attention.py``), on every block; residual pooling (``+ q``);
the shortcut's projection of the normed input where the width expands and its
3×3/2 max-pool where q is strided; exact-erf GELU; eps 1e-6 everywhere.
Input is NHWC ``(B, H, W, 3)`` at the size the tower was built for (224×224
by default: its rel-pos tables and distance maps depend on it); output
``(B, dims[-1])``, or with ``tokens=True`` the normed tokens as their grid
``(B, h, w, dims[-1])``, as skinjax returns them. CAM (``capture``/
``feature_delta``, ``backbones/capture.py``): the grid is that normed token
grid, before the mean, as in skinjax.

Precision: under autocast (the multimodal model's ``dtype``) convolutions
and linears run in the autocast dtype, LayerNorm returns fp32 and the
residual adds widen, so the residual stream is fp32 (skinjax's bf16 modules
keep it in bf16). The attention casts the normed q, k, v and the two bias
terms to the autocast dtype, as skinjax's module gives its kernel its dtype
everywhere, so K11 runs in bf16 there; residual pooling adds that cast q.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.models.backbones.vit import Mlp, layer_norm
from skinjax_torch.ops import compute_dtype
from skinjax_torch.ops.pooled_attention import pooled_attention

FEATURE_DIM = 768


def _rel_pos_dists(q_size: int, k_size: int) -> np.ndarray:
    """timm cal_rel_pos_type distance map (q_size, k_size) -> table index
    (a copy of skinjax's)."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    dist = (np.arange(q_size)[:, None] * q_ratio
            - np.arange(k_size)[None, :] * k_ratio)
    dist += (k_size - 1) * k_ratio
    return dist.astype(np.int64)


def _pooled(size: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """A 3×3 convolution's output size at ``stride`` with padding 1."""
    return tuple((s - 1) // stride + 1 for s in size)


class MViTAttention(nn.Module):
    """MultiScaleAttention, mode='conv', pool_first=False: qkv → per-head
    pooling + LayerNorm → decomposed rel-pos bias → K11 → + q → proj."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int, stride_q: int, stride_kv: int,
                 feat: Tuple[int, int], *, device=None):
        super().__init__()
        self.num_heads, self.feat = num_heads, tuple(feat)
        hd = dim_out // num_heads
        self.qkv = nn.Linear(dim_in, 3 * dim_out, device=device)
        for t, stride in (("q", stride_q), ("k", stride_kv), ("v", stride_kv)):
            setattr(self, f"pool_{t}", nn.Conv2d(hd, hd, 3, stride=stride, padding=1, groups=hd,
                                                 bias=False, device=device))
            setattr(self, f"norm_{t}", layer_norm(hd, device=device))
        self.q_size, self.k_size = _pooled(feat, stride_q), _pooled(feat, stride_kv)
        rel_dim = 2 * max(self.q_size[0], self.k_size[0]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_dim, hd, device=device))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_dim, hd, device=device))
        for name, axis in (("dist_h", 0), ("dist_w", 1)):
            self.register_buffer(name, torch.from_numpy(
                _rel_pos_dists(self.q_size[axis], self.k_size[axis])).to(device), persistent=False)
        self.proj = nn.Linear(dim_out, dim_out, device=device)

    def _pool(self, t: torch.Tensor, t_name: str) -> torch.Tensor:
        """(B, N, h, hd) → the head-shared depthwise conv and its LayerNorm →
        (B, h, N', hd)."""
        B, _, h, hd = t.shape
        m = t.permute(0, 2, 3, 1).reshape(B * h, hd, *self.feat)
        m = getattr(self, f"pool_{t_name}")(m)
        m = m.reshape(B, h, hd, -1).transpose(-1, -2)
        return getattr(self, f"norm_{t_name}")(m)

    def forward(self, x):
        B, N, _ = x.shape
        h = self.num_heads
        d = self.proj.in_features
        hd = d // h
        qkv = self.qkv(x)
        # timm's unit order [q|k|v][head][hd]
        q, k, v = (self._pool(qkv[..., i * d:(i + 1) * d].reshape(B, N, h, hd), t)
                   for i, t in enumerate("qkv"))
        dt = compute_dtype(qkv)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        (qh, qw), (kh, kw) = self.q_size, self.k_size
        Rh = self.rel_pos_h[self.dist_h].to(dt)  # (qh, kh, hd)
        Rw = self.rel_pos_w[self.dist_w].to(dt)  # (qw, kw, hd)
        r_q = q.reshape(B, h, qh, qw, hd)
        bias_h = torch.einsum("byhwc,hkc->byhwk", r_q, Rh).reshape(B, h, qh * qw, kh)
        bias_w = torch.einsum("byhwc,wkc->byhwk", r_q, Rw).reshape(B, h, qh * qw, kw)
        out = pooled_attention(q, k, v, bias_h, bias_w, (kh, kw)) + q  # residual pooling
        return self.proj(out.transpose(1, 2).reshape(B, qh * qw, d))


class MViTBlock(nn.Module):
    """norm1 → (shortcut: projection of the normed input where the width
    expands, 3×3 max-pool where q is strided) + attention → norm2 → MLP →
    +res."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int, stride_q: int, stride_kv: int,
                 feat: Tuple[int, int], mlp_ratio: float = 4.0, *, device=None):
        super().__init__()
        self.stride_q, self.feat = stride_q, tuple(feat)
        self.norm1 = layer_norm(dim_in, device=device)
        if dim_in != dim_out:
            self.shortcut_proj_attn = nn.Linear(dim_in, dim_out, device=device)
        self.attn = MViTAttention(dim_in, dim_out, num_heads, stride_q, stride_kv, feat,
                                  device=device)
        self.norm2 = layer_norm(dim_out, device=device)
        self.mlp = Mlp(dim_out, mlp_ratio, device=device)

    def forward(self, x):
        B = x.shape[0]
        y = self.norm1(x)
        shortcut = self.shortcut_proj_attn(y) if hasattr(self, "shortcut_proj_attn") else x
        if self.stride_q > 1:
            C = shortcut.shape[-1]
            m = shortcut.transpose(1, 2).reshape(B, C, *self.feat)
            m = F.max_pool2d(m, 3, stride=self.stride_q, padding=1)
            shortcut = m.flatten(2).transpose(1, 2)
        x = shortcut + self.attn(y)
        return x + self.mlp(self.norm2(x))


class MViTv2(nn.Module):
    """timm's mvitv2 topology (expanding qkv, conv pooling, decomposed
    rel-pos, residual pooling); ``mvitv2_small`` by default. x (B, H, W, 3)
    NHWC at ``img_size`` → (B, dims[-1])."""

    def __init__(self, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (1, 2, 11, 2), heads: Sequence[int] = (1, 2, 4, 8),
                 stride_kv_adaptive: int = 4, img_size: int = 224, *, device=None):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dims[0], 7, stride=4, padding=3, device=device)
        self.img_size = img_size
        feat = _pooled((img_size, img_size), 4)  # 7×7/4 with padding 3: the same size
        dim_in, kv_stride = dims[0], stride_kv_adaptive
        self.stages = nn.ModuleList()
        for si, (dim, depth, h) in enumerate(zip(dims, depths, heads)):
            stage_stride_q = 2 if si > 0 else 1
            if stage_stride_q > 1:
                kv_stride = max(kv_stride // stage_stride_q, 1)
            stage = nn.Module()  # timm's stages.{i}.blocks.{j}
            stage.blocks = nn.ModuleList()
            for bi in range(depth):
                sq = stage_stride_q if bi == 0 else 1
                stage.blocks.append(MViTBlock(dim_in, dim, h, sq, kv_stride, feat, device=device))
                feat = stage.blocks[-1].attn.q_size
                dim_in = dim
            self.stages.append(stage)
        self.norm = layer_norm(dims[-1], device=device)

    def forward(self, x, tokens: bool = False, capture: bool = False, feature_delta=None):
        if tuple(x.shape[1:3]) != (self.img_size, self.img_size):
            raise ValueError(f"this MViTv2 was built for {self.img_size}x{self.img_size} images "
                             f"(its rel-pos tables depend on the size); got "
                             f"{x.shape[1]}x{x.shape[2]}")
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
        x = self.norm(x)
        grid_hw = self.stages[-1].blocks[-1].attn.q_size
        if tokens:
            return x.reshape(x.shape[0], *grid_hw, x.shape[-1])
        if not capture and feature_delta is None:
            return x.mean(dim=1)
        grid = add_delta(x.reshape(x.shape[0], *grid_hw, x.shape[-1]), feature_delta)
        pooled = grid.reshape(x.shape).mean(dim=1)
        return (pooled, grid) if capture else pooled


def mvitv2_small(*, device=None) -> MViTv2:
    return MViTv2(device=device)
