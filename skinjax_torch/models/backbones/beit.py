"""BEiT / BEiT-v2, timm's ``beit.py`` layout (counterpart of
``skinjax/models/backbones/beit.py``).

patch embedding (conv 16×16/16) → CLS token (no absolute position
embedding) → ``depth`` blocks (LayerNorm → attention → ·gamma_1 → +res →
LayerNorm → MLP with exact GELU → ·gamma_2 → +res) → mean over the patch
tokens → ``fc_norm``. Parameter names are timm's ``state_dict`` keys, which
``skinjax.models.torch_import.import_beit`` reads: ``patch_embed.proj``,
``cls_token``, ``blocks.{i}.{gamma_1, gamma_2, norm1, attn.qkv.weight (no
bias), attn.q_bias, attn.v_bias, attn.relative_position_bias_table,
attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``fc_norm`` (created last, so the
freeze policy's "last layer" is ``fc_norm``, as in skinjax).

Attention: the packed qkv projection with q and v biases (k's bias is a
fixed zero), the per-block relative position bias gathered from its table as
fp32 ``(h, N, N)`` (the index map is a non-persistent buffer, a copy of
skinjax's ``beit_relative_position_index``), the global attention core K12
(``ops/global_attention.py``) with that bias, then the output projection.
The bias table's gradient goes back through the gather, which on the card
sums in another order than on the CPU. Input is NHWC ``(B, H, W, 3)`` at the
size the index map was made for (224×224 by default); output ``(B, dim)``,
or with ``tokens=True`` the last block's tokens ``(B, 1 + patches, dim)``,
CLS first and before ``fc_norm``, as skinjax returns them. CAM
(``capture``/``feature_delta``, ``backbones/capture.py``): the grid is the
last block's patch tokens, before the mean and ``fc_norm``, as in skinjax.
skinjax's ``scan_blocks``, ``seq_shard_axis`` and ``SKINJAX_REMAT`` are not
ported (ROADMAP.md).
Precision as in ``vit.py``: the residual stream is fp32 under autocast.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.models.backbones.vit import Mlp, PatchEmbed, layer_norm
from skinjax_torch.ops.global_attention import attention_core


def beit_relative_position_index(h: int, w: int) -> np.ndarray:
    """timm beit.gen_relative_position_index for a (h, w) token grid with a
    cls token: (h*w+1, h*w+1) int map into a ((2h-1)(2w-1)+3, heads) table."""
    num_rel = (2 * h - 1) * (2 * w - 1)
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    idx = np.zeros((h * w + 1, h * w + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel      # cls -> all
    idx[0:, 0] = num_rel + 1  # all -> cls
    idx[0, 0] = num_rel + 2   # cls -> cls
    return idx


class BeitAttention(nn.Module):
    """Packed qkv with q/v-only biases + relative position bias → K12 → proj."""

    def __init__(self, dim: int, num_heads: int, grid: int, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * grid - 1) ** 2 + 3, num_heads, device=device))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(beit_relative_position_index(grid, grid)).to(device),
            persistent=False)
        self.proj = nn.Linear(dim, dim, device=device)

    def relative_bias(self) -> torch.Tensor:
        """The (h, N, N) fp32 bias gathered from the table."""
        N = self.relative_position_index.shape[0]
        idx = self.relative_position_index.reshape(-1)
        return self.relative_position_bias_table[idx].reshape(N, N, -1).permute(2, 0, 1)

    def forward(self, x):
        C = x.shape[-1]
        if x.shape[1] != self.relative_position_index.shape[0]:
            raise ValueError(f"the relative position index covers "
                             f"{self.relative_position_index.shape[0]} tokens; got {x.shape[1]}")
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        out = attention_core(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                             self.relative_bias(), None, None, self.num_heads)
        return self.proj(out)


class BeitBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: int, layerscale_init: float = 1e-5, *,
                 device=None):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.full((dim,), layerscale_init, device=device))
        self.gamma_2 = nn.Parameter(torch.full((dim,), layerscale_init, device=device))
        self.norm1 = layer_norm(dim, device=device)
        self.attn = BeitAttention(dim, num_heads, grid, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, device=device)

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class Beit(nn.Module):
    """x (B, H, W, 3) NHWC → fc_norm(mean over the patch tokens), (B, dim)."""

    def __init__(self, dim: int = 1024, depth: int = 24, num_heads: int = 16, patch: int = 16,
                 img_size: int = 224, *, device=None):
        super().__init__()
        grid = img_size // patch
        self.patch = patch
        self.patch_embed = PatchEmbed(dim, patch, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.blocks = nn.ModuleList(BeitBlock(dim, num_heads, grid, device=device)
                                    for _ in range(depth))
        self.fc_norm = layer_norm(dim, device=device)

    def forward(self, x, tokens: bool = False, capture: bool = False, feature_delta=None):
        grid_hw = (x.shape[1] // self.patch, x.shape[2] // self.patch)
        x = self.patch_embed(x)
        B, T, D = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, D), x], dim=1)
        for block in self.blocks:
            x = block(x)
        if tokens:
            return x
        grid = add_delta(x[:, 1:].reshape(B, *grid_hw, D), feature_delta)
        pooled = self.fc_norm(grid.reshape(B, T, D).mean(dim=1))
        return (pooled, grid) if capture else pooled


beitv2_large = partial(Beit, dim=1024, depth=24, num_heads=16, patch=16)
beitv2_base = partial(Beit, dim=768, depth=12, num_heads=12, patch=16)
