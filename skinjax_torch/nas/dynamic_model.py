"""DynamicCNN, the NAS search-space model (counterpart of
``skinjax/nas/dynamic_model.py``; dynamicMultimodalmodel.py:6-219).

A conv stack built from the config (a bias-free conv, GroupNorm(min(8, C))
with flax's epsilon of 1e-6, ReLU, a 2×2 max-pool per block while the map is
at least 2×2), the one-hot metadata MLP, one of four fusions
(concatenation, crossattention, metablock, gfcam) and the dropout-0.3
classifier. Images come in NHWC, as in the JAX package; ``capture=True``
also returns the last map (NHWC) and its global average.

The fusion's sequence-length-1 attention is ``ops/attention.py``'s
``MultiheadAttention`` (the exact collapse ``out_proj(v_proj(kv))``), and
metablock is ``models/fusion/blocks.py``'s ``MetaBlock``. Parameter names
follow skinjax's scopes (``conv{b}_{l}``, ``gn{b}_{l}``, ``text_in``, …), so
``models/weights.py`` ``dynamic_state_dict_from_flax`` carries a JAX tree
across key for key.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from skinjax_torch.models.fusion.blocks import MetaBlock
from skinjax_torch.nas.search_space import filters_from_config
from skinjax_torch.ops.attention import MultiheadAttention

GN_EPS = 1e-6  # flax nn.GroupNorm's default, which DynamicCNN keeps
MECHANISMS = ("concatenation", "crossattention", "metablock", "gfcam")


class DynamicCNN(nn.Module):
    def __init__(self, config: Mapping, num_classes: int = 6, vocab_size: int = 85,
                 num_heads: int = 8, text_encoder_dim_output: int = 512):
        super().__init__()
        cfg = dict(config)
        self.config = cfg
        k = int(cfg.get("kernel_size", 3))
        self.mechanism = mech = cfg.get("attention_mecanism", "concatenation")
        if mech not in MECHANISMS:
            raise ValueError(f"unknown fusion '{mech}' for DynamicCNN")
        self.layers_per_block = int(cfg.get("layers_per_block", 2))
        self.use_pooling = bool(cfg.get("use_pooling", True))
        self.filters = filters_from_config(cfg)
        common_dim = int(cfg.get("common_dim", 512))

        c_in = 3
        for bi, out_ch in enumerate(self.filters):
            for li in range(self.layers_per_block):
                self.add_module(f"conv{bi}_{li}",
                                nn.Conv2d(c_in, out_ch, k, padding=k // 2, bias=False))
                self.add_module(f"gn{bi}_{li}", nn.GroupNorm(min(8, out_ch), out_ch, eps=GN_EPS))
                c_in = out_ch
        img_dim = c_in

        n_text = int(cfg.get("neurons_per_layer_size_of_text_fc", 512))
        self.text_layers = int(cfg.get("num_layers_text_fc", 2))
        self.text_in = nn.Linear(vocab_size, n_text)
        for i in range(self.text_layers):
            self.add_module(f"text_h{i}", nn.Linear(n_text, n_text))
        self.text_out = nn.Linear(n_text, text_encoder_dim_output)

        if mech == "metablock":
            self.meta_block = MetaBlock(text_encoder_dim_output, img_dim)
            fused_dim = img_dim
        else:
            self.img_proj = nn.Linear(img_dim, common_dim)
            self.txt_proj = nn.Linear(text_encoder_dim_output, common_dim)
            if mech in ("crossattention", "gfcam"):
                heads = num_heads if common_dim % num_heads == 0 else 1
                self.img_cross = MultiheadAttention(common_dim, heads)
                self.txt_cross = MultiheadAttention(common_dim, heads)
                if mech == "gfcam":
                    self.img_gate = nn.Linear(common_dim, common_dim)
                    self.txt_gate = nn.Linear(common_dim, common_dim)
            fused_dim = 2 * common_dim

        n_fc = int(cfg.get("neurons_per_layer_size_of_fc_module", 512))
        self.fc_layers = int(cfg.get("num_layers_fc_module", 2))
        for i in range(self.fc_layers):
            self.add_module(f"fc{i}", nn.Linear(fused_dim if i == 0 else n_fc, n_fc))
        self.dropout = nn.Dropout(0.3)
        self.fc_out = nn.Linear(n_fc, num_classes)

    def forward(self, image, metadata, capture: bool = False):
        x = image.permute(0, 3, 1, 2)
        for bi in range(len(self.filters)):
            for li in range(self.layers_per_block):
                x = getattr(self, f"conv{bi}_{li}")(x)
                x = torch.relu(getattr(self, f"gn{bi}_{li}")(x))
            if self.use_pooling and min(x.shape[2], x.shape[3]) >= 2:
                x = F.max_pool2d(x, 2)
        img_feat = x.mean(dim=(2, 3))

        t = torch.relu(self.text_in(metadata))
        for i in range(self.text_layers):
            t = torch.relu(getattr(self, f"text_h{i}")(t))
        txt_feat = self.text_out(t)

        mech = self.mechanism
        if mech == "metablock":
            fused = self.meta_block(img_feat, txt_feat)
        else:
            proj_img, proj_txt = self.img_proj(img_feat), self.txt_proj(txt_feat)
            if mech == "concatenation":
                fused = torch.cat([proj_img, proj_txt], dim=-1)
            else:
                i_seq, t_seq = proj_img[:, None], proj_txt[:, None]
                i_x = self.img_cross(i_seq, t_seq, t_seq)[:, 0]
                t_x = self.txt_cross(t_seq, i_seq, i_seq)[:, 0]
                if mech == "gfcam":
                    i_x = torch.sigmoid(self.img_gate(i_x)) * i_x
                    t_x = torch.sigmoid(self.txt_gate(t_x)) * t_x
                fused = torch.cat([i_x, t_x], dim=-1)

        h = fused
        for i in range(self.fc_layers):
            h = self.dropout(torch.relu(getattr(self, f"fc{i}")(h)))
        logits = self.fc_out(h)
        if capture:
            return logits, {"feature_map": x.permute(0, 2, 3, 1), "img_feat": img_feat}
        return logits


_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut at ±2 (flax's correction)


@torch.no_grad()
def lecun_init(module: nn.Module, seed: int) -> nn.Module:
    """The initialisers skinjax's NAS modules draw, drawn on the CPU from
    ``seed``: conv kernels and dense weights LeCun normal over the fan-in,
    truncated at two deviations (flax's ``lecun_normal``); the cross
    attention's projections Xavier uniform over each D×D block (skinjax's
    ``MultiHeadAttention``); embeddings normal with std dim^-0.5 (flax's
    ``Embed``); an LSTM cell's input weights LeCun and its recurrent weights
    orthogonal, gate by gate (flax's ``LSTMCell``); biases zero, norm scales
    one."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    embeddings = {id(m.weight) for m in module.modules() if isinstance(m, nn.Embedding)}
    for name, p in module.named_parameters():
        if p.dim() < 2:
            p.fill_(0.0 if "bias" in name.rsplit(".", 1)[-1] else 1.0)
        elif id(p) in embeddings:
            p.copy_(torch.randn(p.shape, generator=g) * p.shape[1] ** -0.5)
        elif "cross" in name:
            bound = (6.0 / (2 * p.shape[1])) ** 0.5
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
        elif name.endswith("weight_hh"):
            for gate in p.chunk(4):
                nn.init.orthogonal_(gate, generator=g)
        else:
            std = p[0].numel() ** -0.5 / _TRUNCATED_STD
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=g)
    return module


def make_dynamic_model(config: Dict, num_classes: int, vocab_size: int,
                       seed: int = 0) -> DynamicCNN:
    """A DynamicCNN for ``config``, initialised from ``seed`` (built on the
    meta device first: ``lecun_init`` draws every parameter)."""
    with torch.device("meta"):
        model = DynamicCNN(config, num_classes=num_classes, vocab_size=vocab_size)
    return lecun_init(model.to_empty(device="cpu"), seed)
