"""Fusion building blocks (counterpart of ``skinjax/models/fusion/blocks.py``).

The blocks that the multimodal model's eighteen mechanisms use are ported;
the others (Stacked/Residual/AlteredResidual/TransformerAttention/
SimpleAttention blocks, MetaNet, FeatureModulation) come with the baselines
and sequence fusion. Parameter names follow the reference checkpoints
(``{image,text}_residual.attn|gate_linear|norm``, ``meta_block.fb|gb.0|1``,
``fc_fusion.0|1|4|5|8``), which
``skinjax.models.torch_import.import_multimodal_checkpoint`` reads.
LayerNorm uses torch's eps of 1e-5; dropout is inert in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from skinjax_torch.ops.attention import MultiheadAttention

LN_EPS = 1e-5


class GatedAlteredResidualBlock(nn.Module):
    """Gated residual attention: ``LN(g*attn(q,k,v) + (1-g)*q)`` with
    ``g = sigmoid(gate_linear(q))``."""

    def __init__(self, dim: int, num_heads: int = 8, dropout_rate: float = 0.1, *, device=None):
        super().__init__()
        self.attn = MultiheadAttention(dim, num_heads, device=device)
        self.dropout = nn.Dropout(dropout_rate)
        self.gate_linear = nn.Linear(dim, dim, device=device)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, q, k, v):
        attn = self.dropout(self.attn(q, k, v))
        gate = torch.sigmoid(self.gate_linear(q))
        return self.norm(gate * attn + (1.0 - gate) * q)


class MetaBlock(nn.Module):
    """MetaBlock FiLM modulation: ``sigmoid(tanh(v * fb(u)) + gb(u))`` with
    ``fb`` and ``gb`` each Linear(u_dim, v_dim) → LayerNorm. For a map
    ``v`` (B, H, W, v_dim) the modulators broadcast over H and W."""

    def __init__(self, u_dim: int, v_dim: int, *, device=None):
        super().__init__()
        self.fb = nn.Sequential(nn.Linear(u_dim, v_dim, device=device),
                                nn.LayerNorm(v_dim, eps=LN_EPS, device=device))
        self.gb = nn.Sequential(nn.Linear(u_dim, v_dim, device=device),
                                nn.LayerNorm(v_dim, eps=LN_EPS, device=device))

    def forward(self, v, u):
        t1, t2 = self.fb(u), self.gb(u)
        if v.dim() == 4:
            t1, t2 = t1[:, None, None], t2[:, None, None]
        return torch.sigmoid(torch.tanh(v * t1) + t2)


class MLPHead(nn.Sequential):
    """The fusion MLP head: Linear(hidden) → LN → ReLU → Dropout →
    Linear(hidden // 2) → LN → ReLU → Dropout → Linear(num_classes).
    Module indices 0, 1, 4, 5, 8 hold the parameters."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int, dropout_rate: float = 0.5,
                 *, device=None):
        super().__init__(
            nn.Linear(in_dim, hidden, device=device),
            nn.LayerNorm(hidden, eps=LN_EPS, device=device),
            nn.ReLU(),
            nn.Dropout(dropout_rate),
            nn.Linear(hidden, hidden // 2, device=device),
            nn.LayerNorm(hidden // 2, eps=LN_EPS, device=device),
            nn.ReLU(),
            nn.Dropout(dropout_rate),
            nn.Linear(hidden // 2, num_classes, device=device),
        )
