"""Vision Transformer, timm's ``vit_*_patch16_224`` topology (counterpart
of ``skinjax/models/backbones/vit.py``).

patch embedding (conv 16×16/16) → CLS token + absolute position embedding →
``depth`` pre-norm blocks (LayerNorm → MHA → +res → LayerNorm → MLP with
exact GELU → +res) → LayerNorm → the CLS token. Parameter names are timm's
``state_dict`` keys, which ``skinjax.models.torch_import.import_vit`` reads:
``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``norm`` (created last, so
the freeze policy's "last layer" is the final norm, as in skinjax).

Attention is the packed qkv projection, the global attention core K12
(``ops/global_attention.py``) with no bias on its head-major slices, then
the output projection. LayerNorm eps is 1e-6. Input is NHWC ``(B, H, W, 3)``
at the size the position embedding was made for (224×224 by default);
output is ``(B, dim)``, or with ``tokens=True`` every normed token ``(B, 1 +
patches, dim)``, CLS first, as skinjax returns them. ``pool="mean"`` reads
out the mean of the normed patch tokens instead of the CLS token. skinjax's
``scan_blocks``, ``seq_shard_axis`` and ``SKINJAX_REMAT`` are not ported
(ROADMAP.md).

CAM (``xai/cam.py``): ``capture=True`` returns ``(pooled, fmap)``, a (B, gh,
gw, dim) patch grid, and ``feature_delta`` (that grid's shape) is added to
it, at skinjax's points: with CLS pooling the grid entering the last block
(a delta on the final grid would not reach the CLS read-out), with mean
pooling the normed grid the read-out averages.

Precision: under autocast (the multimodal model's ``dtype``) the convolution,
linears and K12 run in the autocast dtype, LayerNorm returns fp32 and the
residual adds widen, so the residual stream is fp32 (skinjax's bf16 modules
keep it in bf16).
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.ops.global_attention import attention_core


def layer_norm(dim: int, *, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6, device=device)


class PatchEmbed(nn.Module):
    """Conv patch×patch, stride patch, on an NHWC image → (B, tokens, dim)."""

    def __init__(self, dim: int, patch: int, *, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, device=device)

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0, *, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, int(dim * ratio), device=device)
        self.fc2 = nn.Linear(int(dim * ratio), dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Attention(nn.Module):
    """Packed qkv (with bias) → K12 → proj."""

    def __init__(self, dim: int, num_heads: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        C = x.shape[-1]
        qkv = self.qkv(x)
        out = attention_core(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], None, None,
                             None, self.num_heads)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, device=None):
        super().__init__()
        self.norm1 = layer_norm(dim, device=device)
        self.attn = Attention(dim, num_heads, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, device=device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """x (B, H, W, 3) NHWC → the normed CLS token (B, dim); with ``tokens``
    every normed token (B, T, dim)."""

    def __init__(self, dim: int = 768, depth: int = 12, num_heads: int = 12, patch: int = 16,
                 img_size: int = 224, pool: str = "cls", *, device=None):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool '{pool}': cls or mean")
        self.pool = pool
        self.patch = patch
        self.patch_embed = PatchEmbed(dim, patch, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (img_size // patch) ** 2 + 1, dim, device=device))
        self.blocks = nn.ModuleList(Block(dim, num_heads, device=device) for _ in range(depth))
        self.norm = layer_norm(dim, device=device)

    def forward(self, x, tokens: bool = False, capture: bool = False, feature_delta=None):
        grid_hw = (x.shape[1] // self.patch, x.shape[2] // self.patch)
        x = self.patch_embed(x)
        B, T, D = x.shape
        if T + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"the position embedding covers {self.pos_embed.shape[1] - 1} "
                             f"patches; the image gives {T}")
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, D), x], dim=1) + self.pos_embed
        cam = capture or feature_delta is not None
        fmap = None
        for i, block in enumerate(self.blocks):
            if cam and self.pool == "cls" and i == len(self.blocks) - 1:
                fmap = add_delta(x[:, 1:].reshape(B, *grid_hw, D), feature_delta)
                x = torch.cat([x[:, :1], fmap.reshape(B, T, D)], dim=1)
            x = block(x)
        x = self.norm(x)
        if tokens:
            return x
        if self.pool == "mean":
            fmap = add_delta(x[:, 1:].reshape(B, *grid_hw, D), feature_delta)
            pooled = fmap.reshape(B, T, D).mean(dim=1)
        else:
            pooled = x[:, 0]
        return (pooled, fmap) if capture else pooled



vit_tiny = partial(VisionTransformer, dim=192, depth=12, num_heads=3)
vit_small = partial(VisionTransformer, dim=384, depth=12, num_heads=6)
vit_base = partial(VisionTransformer, dim=768, depth=12, num_heads=12)
vit_large = partial(VisionTransformer, dim=1024, depth=24, num_heads=16)
