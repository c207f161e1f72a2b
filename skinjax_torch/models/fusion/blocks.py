"""Fusion building blocks (counterpart of ``skinjax/models/fusion/blocks.py``).

Every block of skinjax's zoo, with skinjax's parameter names where the
reference checkpoints do not fix others. The multimodal model's blocks keep
the reference's names (``{image,text}_residual.attn|gate_linear|norm``,
``meta_block.fb|gb.0|1``, ``fc_fusion.0|1|4|5|8``), which
``skinjax.models.torch_import.import_multimodal_checkpoint`` reads, and
``MetaNet`` keeps the reference's 1×1-conv layout (``metanet.0`` and
``metanet.2``, weights (out, in, 1, 1)), which ``import_mdnet`` reads.
Flax infers a Dense layer's input width; here it comes from the
constructor's arguments. LayerNorm uses torch's eps of 1e-5; dropout is inert
in eval mode, and attention dropout lives in ``MultiheadAttention``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.ops.attention import MultiheadAttention

LN_EPS = 1e-5


def layer_norm(dim: int, *, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS, device=device)


class GatedAlteredResidualBlock(nn.Module):
    """Gated residual attention: ``LN(g*attn(q,k,v) + (1-g)*q)`` with
    ``g = sigmoid(gate_linear(q))``."""

    def __init__(self, dim: int, num_heads: int = 8, dropout_rate: float = 0.1, *, device=None):
        super().__init__()
        self.attn = MultiheadAttention(dim, num_heads, device=device)
        self.dropout = nn.Dropout(dropout_rate)
        self.gate_linear = nn.Linear(dim, dim, device=device)
        self.norm = layer_norm(dim, device=device)

    def forward(self, q, k, v):
        attn = self.dropout(self.attn(q, k, v))
        gate = torch.sigmoid(self.gate_linear(q))
        return self.norm(gate * attn + (1.0 - gate) * q)


class StackedGatedResidualBlock(nn.Module):
    """``depth`` gated residual blocks (``block_{i}``); q threads through the
    stack, k and v stay fixed (q where not given)."""

    def __init__(self, dim: int, depth: int = 4, num_heads: int = 8, dropout_rate: float = 0.1,
                 *, device=None):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", GatedAlteredResidualBlock(dim, num_heads, dropout_rate,
                                                                    device=device))

    def forward(self, q, k=None, v=None):
        k = q if k is None else k
        v = q if v is None else v
        for i in range(self.depth):
            q = getattr(self, f"block_{i}")(q, k, v)
        return q


class ResidualBlock(nn.Module):
    """Post-norm residual attention: ``LN(dropout(attn(q,k,v)) + q)``. The
    reference's 512 heads (one channel a head at D=512) are the default."""

    def __init__(self, dim: int, num_heads: int = 512, dropout_rate: float = 0.1, *, device=None):
        super().__init__()
        self.attn = MultiheadAttention(dim, num_heads, device=device)
        self.dropout = nn.Dropout(dropout_rate)
        self.norm = layer_norm(dim, device=device)

    def forward(self, q, k, v):
        return self.norm(self.dropout(self.attn(q, k, v)) + q)


class AlteredResidualBlock(nn.Module):
    """Pre-norm attention with a learned scalar ``alpha`` on the residual,
    then a post-norm FFN: ``out1 = q + alpha·dropout(attn(LN(q), k, v))``,
    ``out = LN(out1 + dropout(ffn_out(dropout(gelu(ffn_in(out1))))))``."""

    def __init__(self, dim: int, num_heads: int = 8, dropout_rate: float = 0.1, *, device=None):
        super().__init__()
        self.norm1 = layer_norm(dim, device=device)
        self.attn = MultiheadAttention(dim, num_heads, device=device)
        self.alpha = nn.Parameter(torch.ones((), device=device))
        self.ffn_in = nn.Linear(dim, 4 * dim, device=device)
        self.ffn_out = nn.Linear(4 * dim, dim, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, q, k, v):
        attn = self.dropout(self.attn(self.norm1(q), k, v))
        out1 = q + self.alpha.to(attn.dtype) * attn
        h = self.dropout(F.gelu(self.ffn_in(out1)))
        return self.norm2(out1 + self.dropout(self.ffn_out(h)))


class TransformerAttentionBlock(nn.Module):
    """Post-norm transformer block: ``x = LN(x + dropout(attn(x)))``, then
    ``LN(x + dropout(ff_out(relu(ff_in(x)))))``; the attention drops its
    weights at the same rate."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.1, *, device=None):
        super().__init__()
        self.attention = MultiheadAttention(dim, num_heads, dropout_rate, device=device)
        self.norm1 = layer_norm(dim, device=device)
        self.ff_in = nn.Linear(dim, 4 * dim, device=device)
        self.ff_out = nn.Linear(4 * dim, dim, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x):
        x = self.norm1(x + self.dropout(self.attention(x, x, x)))
        h = self.ff_out(torch.relu(self.ff_in(x)))
        return self.norm2(x + self.dropout(h))


class SimpleAttentionBlock(nn.Module):
    """Self-attention with attention dropout, then dropout."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.1, *, device=None):
        super().__init__()
        self.attention = MultiheadAttention(dim, num_heads, dropout_rate, device=device)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x):
        return self.dropout(self.attention(x, x, x))


class MetaBlock(nn.Module):
    """MetaBlock FiLM modulation: ``sigmoid(tanh(v * fb(u)) + gb(u))`` with
    ``fb`` and ``gb`` each Linear(u_dim, v_dim) → LayerNorm. For a map
    ``v`` (B, H, W, v_dim) the modulators broadcast over H and W."""

    def __init__(self, u_dim: int, v_dim: int, *, device=None):
        super().__init__()
        self.fb = nn.Sequential(nn.Linear(u_dim, v_dim, device=device),
                                layer_norm(v_dim, device=device))
        self.gb = nn.Sequential(nn.Linear(u_dim, v_dim, device=device),
                                layer_norm(v_dim, device=device))

    def forward(self, v, u):
        t1, t2 = self.fb(u), self.gb(u)
        if v.dim() == 4:
            t1, t2 = t1[:, None, None], t2[:, None, None]
        return torch.sigmoid(torch.tanh(v * t1) + t2)


class MetaNet(nn.Module):
    """Metadata channel gates: ``feat * sigmoid(W2 relu(W1 u + b1) + b2)``.
    The weights keep the reference's 1×1 convs (``metanet.0``,
    ``metanet.2``); on a 1×1 map a 1×1 conv is a linear layer, and it runs as
    one. A map ``feat`` (B, H, W, C) takes the gates over H and W."""

    def __init__(self, meta_dim: int, middle_channels: int, out_channels: int, *, device=None):
        super().__init__()
        self.metanet = nn.Sequential(
            nn.Conv2d(meta_dim, middle_channels, 1, device=device),
            nn.ReLU(),
            nn.Conv2d(middle_channels, out_channels, 1, device=device),
            nn.Sigmoid(),
        )

    def forward(self, feat_maps, metadata):
        c1, c2 = self.metanet[0], self.metanet[2]
        h = torch.relu(F.linear(metadata, c1.weight.flatten(1), c1.bias))
        gates = torch.sigmoid(F.linear(h, c2.weight.flatten(1), c2.bias))
        if feat_maps.dim() == 4:
            gates = gates[:, None, None]
        return feat_maps * gates


class FeatureModulation(nn.Module):
    """FiLM scale and shift from metadata: ``v * scale(u) + shift(u)``,
    broadcast over the sequence of a (B, S, dim) ``v``."""

    def __init__(self, meta_dim: int, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Linear(meta_dim, dim, device=device)
        self.shift = nn.Linear(meta_dim, dim, device=device)

    def forward(self, visual_feats, metadata):
        scale, shift = self.scale(metadata), self.shift(metadata)
        if visual_feats.dim() == 3:
            scale, shift = scale[:, None], shift[:, None]
        return visual_feats * scale + shift


class MLPHead(nn.Sequential):
    """The fusion MLP head: Linear(hidden) → LN → ReLU → Dropout →
    Linear(hidden // 2) → LN → ReLU → Dropout → Linear(num_classes).
    Module indices 0, 1, 4, 5, 8 hold the parameters."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, dropout_rate: float = 0.5,
                 *, device=None):
        super().__init__(
            nn.Linear(in_dim, hidden, device=device),
            layer_norm(hidden, device=device),
            nn.ReLU(),
            nn.Dropout(dropout_rate),
            nn.Linear(hidden, hidden // 2, device=device),
            layer_norm(hidden // 2, device=device),
            nn.ReLU(),
            nn.Dropout(dropout_rate),
            nn.Linear(hidden // 2, num_classes, device=device),
        )


class MLP(nn.Module):
    """ReLU MLP ``in_dim → features[0] → … → features[-1]`` (``fc{i}``), with
    dropout after each hidden activation where ``dropout_rate`` > 0."""

    def __init__(self, in_dim: int, features: Sequence[int], dropout_rate: float = 0.0, *,
                 device=None):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", nn.Linear(in_dim, f, device=device))
            in_dim = f
        self.dropout: Optional[nn.Dropout] = nn.Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
                if self.dropout is not None:
                    x = self.dropout(x)
        return x
