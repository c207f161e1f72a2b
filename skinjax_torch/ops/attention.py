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
then, for self-attention shapes (Sq == Skv) without a mask, the global
attention core K12 (``ops/global_attention.py``) on the head-major
projections; otherwise (cross-attention over another length, or a boolean
mask, True = attend, whose dropped logits become ``finfo.min``) plain
PyTorch, as skinjax leaves that case to XLA.

Layout is batch-first ``(B, S, D)``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.ops.global_attention import attention_core


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, *, device=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim={embed_dim} not divisible by num_heads={num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def v_proj(self):
        """The v-third of the packed projection: (weight (D, D), bias (D,))."""
        d = self.embed_dim
        return self.in_proj_weight[2 * d:], self.in_proj_bias[2 * d:]

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q: (B, Sq, D); k, v: (B, Skv, D); mask: boolean, broadcastable to
        (B, h, Sq, Skv), True where a query attends. Returns (B, Sq, D)."""
        if q.shape[1] == 1 and k.shape[1] == 1 and mask is None:
            w, b = self.v_proj()
            return self.out_proj(F.linear(v, w, b))
        d, h = self.embed_dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        qh, kh, vh = (F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
                      for i, x in enumerate((q, k, v)))
        if q.shape[1] == k.shape[1] and mask is None:
            return self.out_proj(attention_core(qh, kh, vh, None, None, None, h))
        B, Sq, _ = qh.shape
        Skv, hd = kh.shape[1], d // h
        with torch.autocast(q.device.type, enabled=False):
            # fp32 logits, divided by sqrt(hd) after the product, as skinjax
            logits = torch.einsum("bqhd,bkhd->bhqk", qh.reshape(B, Sq, h, hd).float(),
                                  kh.reshape(B, Skv, h, hd).float()) / hd ** 0.5
            if mask is not None:
                logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
            weights = torch.softmax(logits, dim=-1).to(qh.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights.float(),
                               vh.reshape(B, Skv, h, hd).float()).to(qh.dtype)
        return self.out_proj(out.reshape(B, Sq, d))
