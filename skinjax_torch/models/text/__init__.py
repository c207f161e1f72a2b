"""Metadata towers (counterpart of ``skinjax/models/text/__init__.py``).

The one-hot MLP tower of the flagship; the static-embedding tower over
precomputed model2vec sentence vectors (``static_embed.py``); TabTransformer
over index-encoded tabular metadata (``data/tabular.py``); and the sentence
towers (BERT and GPT-2, ``bert.py``, ``gpt2.py``, ``sentence.py``) of the
sentence datasets. Input widths that flax infers come from the constructors'
arguments.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from skinjax_torch.models.fusion.blocks import TransformerAttentionBlock


class OneHotMLP(nn.Sequential):
    """vocab_size → 256 → ReLU → 512 → ReLU → out_dim. Held by the
    multimodal model as ``text_fc``, so its parameters are
    ``text_fc.0|2|4``."""

    def __init__(self, vocab_size: int, out_dim: int = 512, *, device=None):
        super().__init__(
            nn.Linear(vocab_size, 256, device=device),
            nn.ReLU(),
            nn.Linear(256, 512, device=device),
            nn.ReLU(),
            nn.Linear(512, out_dim, device=device),
        )


class StaticEmbeddingTower(nn.Module):
    """Projection over precomputed sentence embeddings: (B, in_dim) →
    ``fc0`` → ReLU → ``fc1`` → (B, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int = 512, hidden: int = 512, *, device=None):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden, device=device)
        self.fc1 = nn.Linear(hidden, out_dim, device=device)

    def forward(self, x):
        return self.fc1(torch.relu(self.fc0(x)))


class TabTransformer(nn.Module):
    """TabTransformer over categorical indices and continuous features.

    x_categorical (B, n_cat) integer indices, one embedding table a column
    (``embed{i}``) → (B, n_cat, embed_dim) → ``num_layers`` post-norm
    transformer blocks (``encoder{i}``, attention over the columns with
    attention dropout) → flatten; with continuous columns, ``numeric_proj``
    of x_numerical (B, n_num) is concatenated → ``fc_hidden`` → ReLU →
    dropout → ``fc_out`` → (B, out_dim)."""

    def __init__(self, categorical_cardinalities: Sequence[int], num_continuous: int,
                 embed_dim: int = 32, num_heads: int = 4, num_layers: int = 2,
                 hidden_dim: int = 128, out_dim: int = 1, dropout_rate: float = 0.3, *,
                 device=None):
        super().__init__()
        self.n_cat = len(categorical_cardinalities)
        self.num_continuous = num_continuous
        self.num_layers = num_layers
        self.out_dim = out_dim
        for i, card in enumerate(categorical_cardinalities):
            self.add_module(f"embed{i}", nn.Embedding(card, embed_dim, device=device))
        for i in range(num_layers):
            self.add_module(f"encoder{i}", TransformerAttentionBlock(
                embed_dim, num_heads, dropout_rate=dropout_rate, device=device))
        width = self.n_cat * embed_dim
        if num_continuous > 0:
            self.numeric_proj = nn.Linear(num_continuous, embed_dim, device=device)
            width += embed_dim
        self.fc_hidden = nn.Linear(width, hidden_dim, device=device)
        self.dropout = nn.Dropout(dropout_rate)
        self.fc_out = nn.Linear(hidden_dim, out_dim, device=device)

    def forward(self, x_categorical: torch.Tensor, x_numerical: Optional[torch.Tensor] = None):
        x = torch.stack([getattr(self, f"embed{i}")(x_categorical[:, i])
                         for i in range(self.n_cat)], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"encoder{i}")(x)
        feats = x.reshape(x.shape[0], -1)
        if self.num_continuous > 0:
            if x_numerical is None:
                raise ValueError(f"this TabTransformer takes {self.num_continuous} continuous "
                                 "columns; got no x_numerical")
            feats = torch.cat([feats, self.numeric_proj(x_numerical).to(feats.dtype)], dim=-1)
        h = self.dropout(torch.relu(self.fc_hidden(feats)))
        return self.fc_out(h)
