"""GPT-2 encoder (counterpart of ``skinjax/models/text/gpt2.py``).

GPT-2 small's topology: token + position embeddings → dropout →
``num_layers`` pre-LN blocks (LayerNorm → causal self-attention from the
packed ``c_attn`` → ``c_proj`` → dropout → +res; LayerNorm → ``c_fc`` → tanh
GELU → ``c_proj`` → dropout → +res) → ``ln_f``, LayerNorm eps 1e-5.
Parameter names are HF torch ``GPT2Model``'s ``state_dict`` keys (``wte``,
``wpe``, ``h.{i}.attn.c_attn``, …), which
``skinjax.models.torch_import.import_torch_gpt2`` reads. HF's ``Conv1D``
keeps its weight as (in, out) and computes ``x @ W + b``; so does
``Conv1D`` here (skinjax's flax tree keeps the transpose, (out, in)).

Attention is the global attention core K12 (``ops/global_attention.py``): q,
k and v are slices of the packed ``c_attn`` output, which K12 takes at their
row stride 3C without a copy; the causal mask is a constant (h, T, T) fp32
bias without a gradient, built once a forward (``causal_bias``); key padding
is the key mask and train-mode attention dropout the ``pmult``, as in
``bert.py``.
"""

from __future__ import annotations

import os
from typing import Mapping, Union

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.text.bert import (
    additive_key_mask,
    attention_dropout_pmult,
    read_config,
)
from skinjax_torch.ops.global_attention import attention_core


def causal_bias(heads: int, T: int, device) -> torch.Tensor:
    """(heads, T, T) fp32, contiguous: 0 where key ≤ query, -1e9 above."""
    ids = torch.arange(T, device=device)
    row = torch.where(ids[None] <= ids[:, None], 0.0, -1e9)
    return row.expand(heads, T, T).contiguous()


class Conv1D(nn.Module):
    """HF's Conv1D: ``weight`` (in, out), ``x @ weight + bias``."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.empty(d_out, device=device))

    def forward(self, x):
        return F.linear(x, self.weight.t(), self.bias)


class _GPT2Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, attn_dropout: float, resid_dropout: float, *,
                 device=None):
        super().__init__()
        self.heads = heads
        self.attn_dropout = attn_dropout
        self.c_attn = Conv1D(hidden, 3 * hidden, device=device)
        self.c_proj = Conv1D(hidden, hidden, device=device)
        self.resid_dropout = nn.Dropout(resid_dropout)

    def forward(self, x, causal, kmask):
        D = x.shape[-1]
        qkv = self.c_attn(x)
        pmult = None
        if self.training and self.attn_dropout > 0.0:
            pmult = attention_dropout_pmult(x.shape[1], self.attn_dropout, x.device)
        y = attention_core(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], causal, kmask,
                           pmult, self.heads)
        return self.resid_dropout(self.c_proj(y))


class _GPT2MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, resid_dropout: float, *, device=None):
        super().__init__()
        self.c_fc = Conv1D(hidden, intermediate, device=device)
        self.c_proj = Conv1D(intermediate, hidden, device=device)
        self.dropout = nn.Dropout(resid_dropout)

    def forward(self, x):
        return self.dropout(self.c_proj(F.gelu(self.c_fc(x), approximate="tanh")))


class _GPT2Block(nn.Module):
    """Pre-LN residual block (HF scope ``h.{i}``)."""

    def __init__(self, hidden, heads, intermediate, attn_dropout, resid_dropout, ln_eps, *,
                 device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden, eps=ln_eps, device=device)
        self.attn = _GPT2Attention(hidden, heads, attn_dropout, resid_dropout, device=device)
        self.ln_2 = nn.LayerNorm(hidden, eps=ln_eps, device=device)
        self.mlp = _GPT2MLP(hidden, intermediate, resid_dropout, device=device)

    def forward(self, x, causal, kmask):
        x = x + self.attn(self.ln_1(x), causal, kmask)
        return x + self.mlp(self.ln_2(x))


class NativeGPT2Encoder(nn.Module):
    """``input_ids`` (B, T) int, ``attention_mask`` (B, T) 1/0 or None →
    the last hidden state after ``ln_f`` (B, T, hidden_size). Defaults are
    GPT-2 small's."""

    def __init__(self, vocab_size: int = 50257, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_position_embeddings: int = 1024, layer_norm_eps: float = 1e-5,
                 embd_dropout: float = 0.1, resid_dropout: float = 0.1,
                 attention_dropout: float = 0.1, *, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.wte = nn.Embedding(vocab_size, hidden_size, device=device)
        self.wpe = nn.Embedding(max_position_embeddings, hidden_size, device=device)
        self.drop = nn.Dropout(embd_dropout)
        self.h = nn.ModuleList(
            _GPT2Block(hidden_size, num_heads, intermediate_size, attention_dropout,
                       resid_dropout, layer_norm_eps, device=device) for _ in range(num_layers))
        self.ln_f = nn.LayerNorm(hidden_size, eps=layer_norm_eps, device=device)

    def forward(self, input_ids, attention_mask=None, position_ids=None):
        B, T = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)[None].expand(B, T)
        x = self.drop(self.wte(input_ids.long()) + self.wpe(position_ids.long()))
        causal = causal_bias(self.num_heads, T, x.device)
        kmask = additive_key_mask(attention_mask)
        for block in self.h:
            x = block(x, causal, kmask)
        return self.ln_f(x)


def config_from_hf_gpt2(config: Union[str, os.PathLike, Mapping]) -> dict:
    """``NativeGPT2Encoder`` kwargs from a HF GPT-2 config (HF's defaults
    for keys it lacks)."""
    c = read_config(config)
    n_embd = c.get("n_embd", 768)
    return dict(
        vocab_size=c.get("vocab_size", 50257),
        hidden_size=n_embd,
        num_layers=c.get("n_layer", 12),
        num_heads=c.get("n_head", 12),
        intermediate_size=c.get("n_inner") or 4 * n_embd,
        max_position_embeddings=c.get("n_positions", 1024),
        layer_norm_eps=c.get("layer_norm_epsilon", 1e-5),
        embd_dropout=c.get("embd_pdrop", 0.1),
        resid_dropout=c.get("resid_pdrop", 0.1),
        attention_dropout=c.get("attn_pdrop", 0.1),
    )
