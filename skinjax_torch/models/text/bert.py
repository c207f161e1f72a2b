"""BERT encoder (counterpart of ``skinjax/models/text/bert.py``).

BERT-base/large topology: embeddings (word + token type + position) →
LayerNorm → dropout → ``num_layers`` post-LN layers (self-attention with
separate q/k/v projections → dense → dropout → LayerNorm(x + residual) →
intermediate dense with exact (erf) GELU → dense → dropout → LayerNorm(x +
residual)), LayerNorm eps 1e-12. No pooler: the sentence tower pools the
last hidden state itself. Parameter names are HF torch ``BertModel``'s
``state_dict`` keys (``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, …), which
``skinjax.models.torch_import.import_torch_bert`` reads.

Attention is the global attention core K12 (``ops/global_attention.py``) on
the head-major q, k and v projections. The padding mask is its key mask,
additive ``0 / -1e9`` in fp32 (skinjax's, which underflows a masked weight
to exactly 0 as HF's ``finfo.min`` does). In train mode the attention
dropout is flax's ``broadcast_dropout=True``: one (T, T) keep draw a layer,
shared over the batch and the heads, scaled by 1/(1 − p) and passed to K12
as its ``pmult`` (``attention_dropout_pmult``). It draws from the device's
default generator, as ``nn.Dropout`` (the hidden dropouts) does, which the
train step seeds per (seed, step).

``NativeSentenceTower`` is the pooled tower around an encoder: ``cls``
pools ``[:, 0]`` (BERT), ``last`` ``[:, -1]`` (GPT-2, the raw final
position, padding included, as skinjax indexes it); skinjax's optional
projection after the pooling (``out_dim``) has no caller and is not ported.
``config_from_hf`` reads a HF ``config.json`` (a dict or a path) without
``transformers``.

Precision: under autocast (the multimodal model's ``dtype``) the linears and
K12 run in the autocast dtype, embeddings and LayerNorm return fp32, so the
residual stream is fp32 (skinjax's bf16 module keeps it in bf16).
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.ops.global_attention import attention_core


def additive_key_mask(attention_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, T) 1 keep / 0 pad → (B, T) fp32 0 / -1e9, or None."""
    if attention_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=attention_mask.device)
    return torch.where(attention_mask > 0, zero, torch.full_like(zero, -1e9))


def attention_dropout_pmult(T: int, rate: float, device,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One (T, T) keep draw at keep probability 1 − rate, as keep / (1 −
    rate) in fp32: flax's broadcast attention dropout, shared over the batch
    and the heads."""
    keep = torch.rand((T, T), generator=generator, device=device) < 1.0 - rate
    return keep.float() / (1.0 - rate)


class _BertSelfAttention(nn.Module):
    """HF scope ``attention.self``: separate q/k/v projections → K12."""

    def __init__(self, hidden: int, heads: int, attn_dropout: float, *, device=None):
        super().__init__()
        self.heads = heads
        self.attn_dropout = attn_dropout
        self.query = nn.Linear(hidden, hidden, device=device)
        self.key = nn.Linear(hidden, hidden, device=device)
        self.value = nn.Linear(hidden, hidden, device=device)

    def forward(self, x, kmask):
        pmult = None
        if self.training and self.attn_dropout > 0.0:
            pmult = attention_dropout_pmult(x.shape[1], self.attn_dropout, x.device)
        return attention_core(self.query(x), self.key(x), self.value(x), None, kmask, pmult,
                              self.heads)


class _DenseLnResidual(nn.Module):
    """HF scopes ``attention.output`` and ``output``: dense → dropout →
    LayerNorm(x + residual)."""

    def __init__(self, d_in: int, hidden: int, dropout: float, ln_eps: float, *, device=None):
        super().__init__()
        self.dense = nn.Linear(d_in, hidden, device=device)
        self.dropout = nn.Dropout(dropout)
        self.LayerNorm = nn.LayerNorm(hidden, eps=ln_eps, device=device)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class _BertAttention(nn.Module):
    def __init__(self, hidden, heads, attn_dropout, hidden_dropout, ln_eps, *, device=None):
        super().__init__()
        self.self = _BertSelfAttention(hidden, heads, attn_dropout, device=device)
        self.output = _DenseLnResidual(hidden, hidden, hidden_dropout, ln_eps, device=device)

    def forward(self, x, kmask):
        return self.output(self.self(x, kmask), x)


class _BertIntermediate(nn.Module):
    def __init__(self, hidden: int, intermediate: int, *, device=None):
        super().__init__()
        self.dense = nn.Linear(hidden, intermediate, device=device)

    def forward(self, x):
        return F.gelu(self.dense(x), approximate="none")


class _BertLayer(nn.Module):
    def __init__(self, hidden, heads, intermediate, attn_dropout, hidden_dropout, ln_eps, *,
                 device=None):
        super().__init__()
        self.attention = _BertAttention(hidden, heads, attn_dropout, hidden_dropout, ln_eps,
                                        device=device)
        self.intermediate = _BertIntermediate(hidden, intermediate, device=device)
        self.output = _DenseLnResidual(intermediate, hidden, hidden_dropout, ln_eps,
                                       device=device)

    def forward(self, x, kmask):
        x = self.attention(x, kmask)
        return self.output(self.intermediate(x), x)


class _BertEncoderScope(nn.Module):
    """HF scope ``encoder``: ``layer.{i}``."""

    def __init__(self, depth: int, *args, device=None):
        super().__init__()
        self.layer = nn.ModuleList(_BertLayer(*args, device=device) for _ in range(depth))

    def forward(self, x, kmask):
        for layer in self.layer:
            x = layer(x, kmask)
        return x


class _BertEmbeddings(nn.Module):
    def __init__(self, vocab, hidden, max_pos, type_vocab, hidden_dropout, ln_eps, *,
                 device=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, hidden, device=device)
        self.position_embeddings = nn.Embedding(max_pos, hidden, device=device)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden, device=device)
        self.LayerNorm = nn.LayerNorm(hidden, eps=ln_eps, device=device)
        self.dropout = nn.Dropout(hidden_dropout)

    def forward(self, input_ids, token_type_ids, position_ids):
        x = (self.word_embeddings(input_ids) + self.token_type_embeddings(token_type_ids)
             + self.position_embeddings(position_ids))
        return self.dropout(self.LayerNorm(x))


class NativeBertEncoder(nn.Module):
    """``input_ids`` (B, T) int, ``attention_mask`` (B, T) 1/0 or None →
    the last hidden state (B, T, hidden_size). Defaults are BERT-base's."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, hidden_dropout: float = 0.1,
                 attention_dropout: float = 0.1, *, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.embeddings = _BertEmbeddings(vocab_size, hidden_size, max_position_embeddings,
                                          type_vocab_size, hidden_dropout, layer_norm_eps,
                                          device=device)
        self.encoder = _BertEncoderScope(num_layers, hidden_size, num_heads, intermediate_size,
                                         attention_dropout, hidden_dropout, layer_norm_eps,
                                         device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, position_ids=None):
        B, T = input_ids.shape
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)[None].expand(B, T)
        x = self.embeddings(input_ids, token_type_ids.long(), position_ids.long())
        return self.encoder(x, additive_key_mask(attention_mask))


class NativeSentenceTower(nn.Module):
    """A sentence encoder (``NativeBertEncoder`` or ``NativeGPT2Encoder``)
    pooled per family: ``cls`` = ``[:, 0]``, ``last`` = ``[:, -1]``."""

    def __init__(self, encoder: nn.Module, pool: str = "cls"):
        super().__init__()
        if pool not in ("cls", "last"):
            raise ValueError(f"pool is 'cls' or 'last', got {pool!r}")
        self.encoder = encoder
        self.pool = pool

    @property
    def hidden_size(self) -> int:
        return int(self.encoder.hidden_size)

    def forward(self, input_ids, attention_mask=None):
        return pool_hidden(self.encoder(input_ids, attention_mask), self.pool)


def pool_hidden(hidden: torch.Tensor, pool: str) -> torch.Tensor:
    """(B, T, D) → (B, D): the first position (``cls``) or the last (``last``)."""
    return hidden[:, -1] if pool == "last" else hidden[:, 0]


def read_config(config: Union[str, os.PathLike, Mapping]) -> dict:
    """A HF ``config.json`` as a dict: the dict itself, a path to the file,
    or a directory holding it."""
    if isinstance(config, Mapping):
        return dict(config)
    path = os.fspath(config)
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        return json.load(f)


def config_from_hf(config: Union[str, os.PathLike, Mapping]) -> dict:
    """``NativeBertEncoder`` kwargs from a HF BERT config (HF's defaults for
    keys it lacks)."""
    c = read_config(config)
    return dict(
        vocab_size=c.get("vocab_size", 30522),
        hidden_size=c.get("hidden_size", 768),
        num_layers=c.get("num_hidden_layers", 12),
        num_heads=c.get("num_attention_heads", 12),
        intermediate_size=c.get("intermediate_size", 3072),
        max_position_embeddings=c.get("max_position_embeddings", 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        layer_norm_eps=c.get("layer_norm_eps", 1e-12),
        hidden_dropout=c.get("hidden_dropout_prob", 0.1),
        attention_dropout=c.get("attention_probs_dropout_prob", 0.1),
    )
