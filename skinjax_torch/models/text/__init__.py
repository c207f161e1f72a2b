"""Metadata towers (counterpart of ``skinjax/models/text/__init__.py``).

The one-hot MLP tower of the flagship, and the sentence towers (BERT and
GPT-2, ``bert.py``, ``gpt2.py``, ``sentence.py``) of the sentence datasets.
The static-embedding and TabTransformer towers are not ported yet.
"""

from __future__ import annotations

from torch import nn


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
