"""Multi-head attention (counterpart of ``skinjax/ops/attention.py``).

The fusion zoo applies ``nn.MultiheadAttention`` to sequence-length-1
tensors. Softmax over a single key is identically 1, so the output there is
exactly

    out = out_proj(v_proj(x_kv))

and the q/k projections do no work. The parameters keep
``nn.MultiheadAttention``'s packed layout (``in_proj_weight`` (3D, D),
``in_proj_bias``, ``out_proj``) so checkpoints load unchanged, and at
sequence length 1 only the v-third of the packed projection is read.

Longer sequences take skinjax's general path: the q, k and v projections,
then the core. ``route`` decides which core from the shapes alone, before
anything launches:

  ``seq1``   Sq = Skv = 1, no mask, attention dropout inert: the collapse above
  ``k12``    a self-attention shape (Sq = Skv) without a mask that the global
             attention core K12 (``ops/global_attention.py``) admits (at most
             ``MAX_HEAD_DIM`` channels a head and ``MAX_TOKENS`` tokens), with
             attention dropout inert
  ``plain``  everything else: cross-attention over another length, a boolean
             mask (True = attend; dropped logits become ``finfo.min``), a
             shape K12 does not admit (skinjax sends those to XLA,
             ``globattn_ok``), or attention dropout in train mode

The route is static: an error from K12 on a shape it admits still raises.
Attention dropout (``dropout_rate``, torch's default 0) drops the fp32
softmax weights in train mode, after the softmax and before the cast, as
skinjax does; it draws from the device's default generator, which the train
step reseeds from its (seed, step) as it does for every ``nn.Dropout``.

Layout is batch-first ``(B, S, D)``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.ops.global_attention import admits, attention_core


def route(q_len: int, kv_len: int, embed_dim: int, num_heads: int, masked: bool = False,
          dropout: bool = False) -> str:
    """``"seq1"``, ``"k12"`` or ``"plain"`` for a call of these shapes;
    ``dropout`` is whether attention dropout is active (rate > 0 in train
    mode)."""
    if dropout or masked:
        return "plain"
    if q_len == 1 and kv_len == 1:
        return "seq1"
    if q_len == kv_len and admits(q_len, embed_dim, num_heads):
        return "k12"
    return "plain"


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout_rate: float = 0.0, *,
                 device=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim={embed_dim} not divisible by num_heads={num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def v_proj(self):
        """The v-third of the packed projection: (weight (D, D), bias (D,))."""
        d = self.embed_dim
        return self.in_proj_weight[2 * d:], self.in_proj_bias[2 * d:]

    def route(self, q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor] = None
              ) -> str:
        """This module's route for a call on q (B, Sq, D) and k (B, Skv, D)."""
        return route(q.shape[1], k.shape[1], self.embed_dim, self.num_heads, mask is not None,
                     self.training and self.dropout_rate > 0)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q: (B, Sq, D); k, v: (B, Skv, D); mask: boolean, broadcastable to
        (B, h, Sq, Skv), True where a query attends. Returns (B, Sq, D)."""
        path = self.route(q, k, mask)
        if path == "seq1":
            w, b = self.v_proj()
            return self.out_proj(F.linear(v, w, b))
        d, h = self.embed_dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        qh, kh, vh = (F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
                      for i, x in enumerate((q, k, v)))
        if path == "k12":
            return self.out_proj(attention_core(qh, kh, vh, None, None, None, h))
        B, Sq, _ = qh.shape
        Skv, hd = kh.shape[1], d // h
        with torch.autocast(q.device.type, enabled=False):
            # fp32 logits, divided by sqrt(hd) after the product, as skinjax
            logits = torch.einsum("bqhd,bkhd->bhqk", qh.reshape(B, Sq, h, hd).float(),
                                  kh.reshape(B, Skv, h, hd).float()) / hd ** 0.5
            if mask is not None:
                logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
            weights = torch.softmax(logits, dim=-1)
            if self.training and self.dropout_rate > 0:
                weights = F.dropout(weights, self.dropout_rate, training=True)
            weights = weights.to(qh.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights.float(),
                               vh.reshape(B, Skv, h, hd).float()).to(qh.dtype)
        return self.out_proj(out.reshape(B, Sq, d))
