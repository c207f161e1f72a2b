"""Weights for the port: conversion from the JAX package's parameter trees,
and random initialisation from a seed.

``state_dict_from_flax`` is the inverse of
``skinjax.models.torch_import.import_multimodal_checkpoint``: it turns a JAX
``MultimodalModel``'s ``(params, batch_stats)`` into a reference/torchvision
``state_dict`` of numpy arrays, which loads into
``skinjax_torch.models.MultimodalModel`` and which the JAX importer reads
back to the same trees. It uses numpy only.

  conv kernels    HWIO → OIHW (a depthwise (3, 3, 1, C) kernel → (C, 1, 3, 3))
  dense kernels   (in, out) → (out, in)
  attention       q/k/v_proj + out_proj → packed in_proj_weight/in_proj_bias + out_proj
  BatchNorm       scale/bias + batch_stats mean/var → weight/bias/running_mean/running_var

Flax creates parameters lazily, only for the submodules a mechanism calls
(RG-ATT has no ``img_gate``), so only the subtrees present are converted.
The image encoder converts by its tree's own markers: a DaViT tree
(``stage0_block0_spatial``), a CAFormer tree (``down1_norm``, or
``token_mixer`` under ``stage0_block0``; it has a ``stem_conv`` too), a
CoaT-lite tree (``patch_embed1_proj``), a Swin tree (``patch_norm``), a ViT
tree (``pos_embed``, per-block
``attn/{q,k,v}_proj``), a BEiT tree (``fc_norm``, per-block
``attn/qkv_kernel``) and an MViTv2 tree (``stage0_block0/attn/rel_pos_h``) to
timm's keys, which ``skinjax.models.torch_import.import_davit``/
``import_caformer``/``import_coat``/``import_swin``/``import_vit``/
``import_beit``/``import_mvit`` read back; a NextViT tree (``stem0_conv``) to
timm's ``stages.{si}.{bi}`` keys (``import_nextvit``); a ResNet tree
(``stem``), a DenseNet tree (``norm_final``), an EfficientNet tree
(``stem_bn`` and ``se`` in ``block0``), a MobileNet-V2 tree (``stem_bn``
alone), a VGG16 tree (``conv0`` and ``fc2``) and a custom-cnn tree
(``conv``, ``fc``) to torchvision's (``import_densenet``,
``import_efficientnet``, ``import_mobilenet_v2``, ``import_vgg16``), BatchNorm
running statistics included. A tokens model's
sentence tower (``text_module/bert`` or ``text_module/gpt2``, HF Flax's
tree) converts to HF torch's ``BertModel``/``GPT2Model`` keys under
``text_encoder.`` (``text_encoder_state_dict``), the inverse of
``import_torch_bert``/``import_torch_gpt2``: Flax Dense kernels (in, out)
transpose to (out, in), GPT-2's Flax Conv1D kernels (out, in) to HF torch's
Conv1D (in, out), embeddings stay as they are. A tabular model's
TabTransformer (``text_module`` with ``fc_hidden``) and the static-embedding
tower (``text_tower`` without ``fc2``) convert to ``text_module.`` and
``text_tower.`` keys. The baselines' trees (``meta_net`` for MD-Net,
``visual_proj`` for LiwTERM, ``metanet`` for MetaNet) and sequence fusion's
(``img_self``) convert with their auto-named tower (``DenseNet_0``,
``ViT_0``, ``ResNet_0``) under ``feature_extractor.`` (MD-Net's DenseNet
``features``, as ``import_mdnet`` reads them) or ``backbone.``, MetaNet's
Denses as the reference's 1×1 convs. ``block_state_dict`` converts one
block of skinjax's zoo by its class name, ``encoder_state_dict`` one image
tower.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from skinjax_torch.models.backbones import beit, coat, swin, vit
from skinjax_torch.models.fusion import blocks
from skinjax_torch.models.text import gpt2
from skinjax_torch.ops.attention import MultiheadAttention


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _linear(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _ln(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _packed_qkv(p: Mapping):
    """skinjax's q/k/v_proj Denses → one packed (3D, D) weight and (3D,) bias."""
    names = ("q_proj", "k_proj", "v_proj")
    return (np.concatenate([_np(p[n]["kernel"]).T for n in names]),
            np.concatenate([_np(p[n]["bias"]) for n in names]))


def _mha(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.in_proj_weight"], sd[f"{prefix}.in_proj_bias"] = _packed_qkv(p)
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _convbn(sd: Dict, conv_key: str, bn_key: str, p: Mapping, s: Mapping) -> None:
    _conv(sd, conv_key, p["conv"])
    sd[f"{bn_key}.weight"] = _np(p["bn"]["scale"])
    sd[f"{bn_key}.bias"] = _np(p["bn"]["bias"])
    sd[f"{bn_key}.running_mean"] = _np(s["bn"]["mean"])
    sd[f"{bn_key}.running_var"] = _np(s["bn"]["var"])
    sd[f"{bn_key}.num_batches_tracked"] = np.array(0, dtype=np.int64)


def _davit(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``DaViT`` params → timm keys (the inverse of ``import_davit``)."""
    _conv(sd, f"{prefix}stem.conv", p["stem_conv"])
    _ln(sd, f"{prefix}stem.norm", p["stem_norm"])
    for name, sub in p.items():
        if name.startswith("down"):
            base = f"{prefix}stages.{name[len('down'):]}.downsample"
            _ln(sd, f"{base}.norm", sub["norm"])
            _conv(sd, f"{base}.conv", sub["conv"])
        elif name.startswith("stage"):  # stage{i}_block{j}_{spatial,channel}
            stage, block, kind = name[len("stage"):].split("_")
            base = f"{prefix}stages.{stage}.blocks.{block[len('block'):]}." \
                   f"{0 if kind == 'spatial' else 1}"
            for cpe in ("cpe1", "cpe2"):
                _conv(sd, f"{base}.{cpe}.proj", sub[cpe]["proj"])
            for norm in ("norm1", "norm2"):
                _ln(sd, f"{base}.{norm}", sub[norm])
            for lin in ("qkv", "proj"):
                _linear(sd, f"{base}.attn.{lin}", sub["attn"][lin])
            for lin in ("fc1", "fc2"):
                _linear(sd, f"{base}.mlp.{lin}", sub["mlp"][lin])
    _ln(sd, f"{prefix}head.norm", p["head_norm"])


def _swin(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``Swin`` params → timm keys (the inverse of ``import_swin``;
    patch merges as timm's ``layers.{i}.downsample``)."""
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"])
    _ln(sd, f"{prefix}patch_embed.norm", p["patch_norm"])
    for name, sub in p.items():
        if name.startswith("merge"):
            base = f"{prefix}layers.{name[len('merge'):]}.downsample"
            _ln(sd, f"{base}.norm", sub["norm"])
            _linear(sd, f"{base}.reduction", sub["reduction"])
        elif name.startswith("stage"):  # stage{i}_block{j}
            stage, block = name[len("stage"):].split("_block")
            base = f"{prefix}layers.{stage}.blocks.{block}"
            for norm in ("norm1", "norm2"):
                _ln(sd, f"{base}.{norm}", sub[norm])
            for lin in ("qkv", "proj"):
                _linear(sd, f"{base}.attn.{lin}", sub["attn"][lin])
            sd[f"{base}.attn.relative_position_bias_table"] = _np(sub["attn"]["rel_bias"])
            for lin in ("fc1", "fc2"):
                _linear(sd, f"{base}.mlp.{lin}", sub["mlp"][lin])
    _ln(sd, f"{prefix}norm", p["norm"])


def _blocks(p: Mapping):
    """The ``block{i}`` subtrees of a ViT or BEiT tree, in block order."""
    return [p[f"block{i}"] for i in range(sum(k.startswith("block") for k in p))]


def _vit(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``ViT`` params → timm keys (the inverse of ``import_vit``)."""
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"])
    sd[f"{prefix}cls_token"] = _np(p["cls_token"])
    sd[f"{prefix}pos_embed"] = _np(p["pos_embed"])
    for i, b in enumerate(_blocks(p)):
        base = f"{prefix}blocks.{i}"
        _ln(sd, f"{base}.norm1", b["norm1"])
        sd[f"{base}.attn.qkv.weight"], sd[f"{base}.attn.qkv.bias"] = _packed_qkv(b["attn"])
        _linear(sd, f"{base}.attn.proj", b["attn"]["out_proj"])
        _ln(sd, f"{base}.norm2", b["norm2"])
        _linear(sd, f"{base}.mlp.fc1", b["mlp_in"])
        _linear(sd, f"{base}.mlp.fc2", b["mlp_out"])
    _ln(sd, f"{prefix}norm", p["norm"])


def _beit(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``Beit`` params → timm keys (the inverse of ``import_beit``)."""
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"])
    sd[f"{prefix}cls_token"] = _np(p["cls_token"])
    for i, b in enumerate(_blocks(p)):
        base = f"{prefix}blocks.{i}"
        sd[f"{base}.gamma_1"] = _np(b["gamma_1"])
        sd[f"{base}.gamma_2"] = _np(b["gamma_2"])
        _ln(sd, f"{base}.norm1", b["norm1"])
        a = b["attn"]
        sd[f"{base}.attn.qkv.weight"] = np.ascontiguousarray(_np(a["qkv_kernel"]).T)
        sd[f"{base}.attn.q_bias"] = _np(a["q_bias"])
        sd[f"{base}.attn.v_bias"] = _np(a["v_bias"])
        sd[f"{base}.attn.relative_position_bias_table"] = _np(a["rel_bias_table"])
        _linear(sd, f"{base}.attn.proj", a["proj"])
        _ln(sd, f"{base}.norm2", b["norm2"])
        _linear(sd, f"{base}.mlp.fc1", b["mlp_fc1"])
        _linear(sd, f"{base}.mlp.fc2", b["mlp_fc2"])
    _ln(sd, f"{prefix}fc_norm", p["fc_norm"])


def _mvit(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``MViTv2`` params → timm keys (the inverse of ``import_mvit``)."""
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"])
    for name, b in p.items():
        if not name.startswith("stage"):  # stage{i}_block{j}
            continue
        stage, block = name[len("stage"):].split("_block")
        base = f"{prefix}stages.{stage}.blocks.{block}"
        a = b["attn"]
        for norm in ("norm1", "norm2"):
            _ln(sd, f"{base}.{norm}", b[norm])
        if "shortcut_proj" in b:
            _linear(sd, f"{base}.shortcut_proj_attn", b["shortcut_proj"])
        for lin in ("qkv", "proj"):
            _linear(sd, f"{base}.attn.{lin}", a[lin])
        for t in "qkv":
            _conv(sd, f"{base}.attn.pool_{t}", a[f"pool_{t}"])
            _ln(sd, f"{base}.attn.norm_{t}", a[f"norm_{t}"])
        sd[f"{base}.attn.rel_pos_h"] = _np(a["rel_pos_h"])
        sd[f"{base}.attn.rel_pos_w"] = _np(a["rel_pos_w"])
        _linear(sd, f"{base}.mlp.fc1", b["mlp_fc1"])
        _linear(sd, f"{base}.mlp.fc2", b["mlp_fc2"])
    _ln(sd, f"{prefix}norm", p["norm"])


def _star(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.scale"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _caformer(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``CAFormer`` params → timm keys (the inverse of
    ``import_caformer``): bias-free LayerNorms keep only ``weight``."""
    _conv(sd, f"{prefix}stem.conv", p["stem_conv"])
    sd[f"{prefix}stem.norm.weight"] = _np(p["stem_norm"]["scale"])
    for name, sub in p.items():
        if name.startswith("down"):  # down{i}_{norm,conv}
            stage, part = name[len("down"):].split("_")
            key = f"{prefix}stages.{stage}.downsample.{part}"
            if part == "norm":
                sd[f"{key}.weight"] = _np(sub["scale"])
            else:
                _conv(sd, key, sub)
        elif name.startswith("stage"):  # stage{i}_block{j}
            stage, block = name[len("stage"):].split("_block")
            base = f"{prefix}stages.{stage}.blocks.{block}"
            for norm in ("norm1", "norm2"):
                sd[f"{base}.{norm}.weight"] = _np(sub[norm]["scale"])
            tm = sub["token_mixer"]
            if "qkv" in tm:
                _linear(sd, f"{base}.token_mixer.qkv", tm["qkv"])
                _linear(sd, f"{base}.token_mixer.proj", tm["proj"])
            else:
                _linear(sd, f"{base}.token_mixer.pwconv1", tm["pwconv1"])
                _star(sd, f"{base}.token_mixer.act1", tm["act1"])
                _conv(sd, f"{base}.token_mixer.dwconv", tm["dwconv"])
                _linear(sd, f"{base}.token_mixer.pwconv2", tm["pwconv2"])
            _linear(sd, f"{base}.mlp.fc1", sub["mlp"]["fc1"])
            _star(sd, f"{base}.mlp.act", sub["mlp"]["act"])
            _linear(sd, f"{base}.mlp.fc2", sub["mlp"]["fc2"])
            for rs in ("res_scale1", "res_scale2"):
                if rs in sub:
                    sd[f"{base}.{rs}.scale"] = _np(sub[rs])
    _ln(sd, f"{prefix}head.norm", p["head_norm"])


_COAT_PARTS = {"norm1": "norm1", "qkv": "factoratt_crpe.qkv", "proj": "factoratt_crpe.proj",
               "norm2": "norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _coat(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``CoaTLite`` params → timm's model-level keys (the inverse of
    ``import_coat``)."""
    for name, sub in p.items():
        if name.startswith("patch_embed"):  # patch_embed{k}_{proj,norm}
            stage, part = name[len("patch_embed"):].split("_")
            (_conv if part == "proj" else _ln)(sd, f"{prefix}patch_embed{stage}.{part}", sub)
        elif name.startswith("cls_token"):
            sd[f"{prefix}{name}"] = _np(sub)
        elif name.startswith("cpe"):
            _conv(sd, f"{prefix}{name}.proj", sub["proj"])
        elif name.startswith("crpe"):
            for conv, q in sub.items():  # conv{i}
                _conv(sd, f"{prefix}{name}.conv_list.{conv[len('conv'):]}", q)
        elif name.startswith("serial"):  # serial{k}_{j}_{part}
            stage, block, part = name[len("serial"):].split("_", 2)
            key = f"{prefix}serial_blocks{stage}.{block}.{_COAT_PARTS[part]}"
            (_ln if part.startswith("norm") else _linear)(sd, key, sub)
    _ln(sd, f"{prefix}norm4", p["norm4"])


def _resnet(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    _convbn(sd, f"{prefix}conv1", f"{prefix}bn1", p["stem"], s["stem"])
    for blk in (k for k in p if k.startswith("layer")):
        stage, idx = blk[len("layer"):].split("_")
        base = f"{prefix}layer{stage}.{idx}"
        for name, sub in p[blk].items():
            if name == "downsample":
                _convbn(sd, f"{base}.downsample.0", f"{base}.downsample.1", sub, s[blk][name])
            else:  # convN
                _convbn(sd, f"{base}.{name}", f"{base}.bn{name[len('conv'):]}", sub, s[blk][name])


def _bn(sd: Dict, key: str, p: Mapping, s: Optional[Mapping]) -> None:
    """A flax BatchNorm → torch's keys; the running statistics where its
    batch_stats are given (a tree of parameters alone, as the freeze
    policy's masks, has none)."""
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])
    if s is not None:
        sd[f"{key}.running_mean"] = _np(s["mean"])
        sd[f"{key}.running_var"] = _np(s["var"])
        sd[f"{key}.num_batches_tracked"] = np.array(0, dtype=np.int64)


def _sub(s: Optional[Mapping], name: str) -> Optional[Mapping]:
    return None if s is None else s.get(name)


def _dense_as_conv1x1(sd: Dict, key: str, p: Mapping) -> None:
    """A flax Dense (in, out) → a 1×1 conv's (out, in, 1, 1) weight and bias."""
    sd[f"{key}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)[:, :, None, None]
    sd[f"{key}.bias"] = _np(p["bias"])


def _blocks_of(p: Mapping, stem: str) -> int:
    """The number of ``{stem}{i}`` subtrees (i a number) in a tree."""
    return sum(k.startswith(stem) and k[len(stem):].isdigit() for k in p)


# NextViT's stage depths by its number of blocks (nextvit_small, nextvit_base)
NEXTVIT_DEPTHS = {20: (3, 4, 10, 3), 30: (3, 4, 20, 3)}


def _nextvit(sd: Dict, prefix: str, p: Mapping, s: Optional[Mapping],
             depths: Optional[Sequence[int]]) -> None:
    """skinjax ``NextViT`` → timm's ``stages.{si}.{bi}`` keys (the inverse of
    ``import_nextvit``); the MLPs as 1×1 convs. The flax tree numbers its
    blocks ``b{idx}`` across stages, so the stage depths come from
    ``depths``, or from the block count for the published towers."""
    for i in range(4):
        _conv(sd, f"{prefix}stem.{i}.conv", p[f"stem{i}_conv"])
        _bn(sd, f"{prefix}stem.{i}.norm", p[f"stem{i}_norm"], _sub(s, f"stem{i}_norm"))
    n = _blocks_of(p, "b")
    depths = depths or NEXTVIT_DEPTHS.get(n)
    if depths is None or sum(depths) != n:
        raise ValueError(f"a NextViT tree of {n} blocks: pass its stage depths")
    idx = 0
    for si, d in enumerate(depths):
        for bi in range(d):
            b, bs, base = p[f"b{idx}"], _sub(s, f"b{idx}"), f"{prefix}stages.{si}.{bi}"
            for name in ("patch_embed", "projection"):
                if "conv" in b.get(name, {}):
                    _conv(sd, f"{base}.{name}.conv", b[name]["conv"])
                    _bn(sd, f"{base}.{name}.norm", b[name]["norm"], _sub(_sub(bs, name), "norm"))
            for name in ("norm", "norm1", "norm2"):
                if name in b:
                    _bn(sd, f"{base}.{name}", b[name], _sub(bs, name))
            if "mhca" in b:
                m = b["mhca"]
                _conv(sd, f"{base}.mhca.group_conv3x3", m["group_conv3x3"])
                _bn(sd, f"{base}.mhca.norm", m["norm"], _sub(_sub(bs, "mhca"), "norm"))
                _conv(sd, f"{base}.mhca.projection", m["projection"])
            if "e_mhsa" in b:
                e = b["e_mhsa"]
                for lin in ("q", "k", "v", "proj"):
                    _linear(sd, f"{base}.e_mhsa.{lin}", e[lin])
                if "norm" in e:
                    _bn(sd, f"{base}.e_mhsa.norm", e["norm"], _sub(_sub(bs, "e_mhsa"), "norm"))
            for lin in ("conv1", "conv2"):
                _dense_as_conv1x1(sd, f"{base}.mlp.{lin}", b["mlp"][lin])
            idx += 1
    _bn(sd, f"{prefix}norm", p["norm"], _sub(s, "norm"))


def _densenet(sd: Dict, prefix: str, p: Mapping, s: Optional[Mapping],
              features: str = "features.") -> None:
    """skinjax ``DenseNet`` → torchvision's ``features.*`` keys (the inverse
    of ``import_densenet``; ``features=""`` for MD-Net's
    ``feature_extractor``, which holds the ``features`` module itself)."""
    f = f"{prefix}{features}"
    _conv(sd, f"{f}conv0", p["conv0"])
    _bn(sd, f"{f}norm0", p["norm0"], _sub(s, "norm0"))
    for name, sub in p.items():
        if name.startswith("block"):  # block{i}_layer{j}
            i, j = (int(t) for t in name[len("block"):].split("_layer"))
            base = f"{f}denseblock{i + 1}.denselayer{j + 1}"
            for norm in ("norm1", "norm2"):
                _bn(sd, f"{base}.{norm}", sub[norm], _sub(_sub(s, name), norm))
            for conv in ("conv1", "conv2"):
                _conv(sd, f"{base}.{conv}", sub[conv])
        elif name.startswith("trans"):  # trans{i}_{norm,conv}
            i, part = name[len("trans"):].split("_")
            key = f"{f}transition{int(i) + 1}.{part}"
            if part == "norm":
                _bn(sd, key, sub, _sub(s, name))
            else:
                _conv(sd, key, sub)
    _bn(sd, f"{f}norm5", p["norm_final"], _sub(s, "norm_final"))


def _convbn_seq(sd: Dict, key: str, p: Mapping, s: Optional[Mapping], conv: str, bn: str) -> None:
    """A flax conv and its BatchNorm → torchvision's Conv2dNormActivation
    keys ``{key}.0`` and ``{key}.1``."""
    _conv(sd, f"{key}.0", p[conv])
    _bn(sd, f"{key}.1", p[bn], _sub(s, bn))


def _mobilenet_v2(sd: Dict, prefix: str, p: Mapping, s: Optional[Mapping]) -> None:
    """skinjax ``MobileNetV2`` → torchvision's ``features.*`` keys (the
    inverse of ``import_mobilenet_v2``)."""
    f = f"{prefix}features."
    _convbn_seq(sd, f"{f}0", p, s, "stem", "stem_bn")
    n = _blocks_of(p, "block")
    for idx in range(n):
        b, bs, base = p[f"block{idx}"], _sub(s, f"block{idx}"), f"{f}{idx + 1}.conv"
        k = 0
        if "expand" in b:
            _convbn_seq(sd, f"{base}.0", b, bs, "expand", "expand_bn")
            k = 1
        _convbn_seq(sd, f"{base}.{k}", b, bs, "dw", "dw_bn")
        _conv(sd, f"{base}.{k + 1}", b["project"])
        _bn(sd, f"{base}.{k + 2}", b["project_bn"], _sub(bs, "project_bn"))
    _convbn_seq(sd, f"{f}{n + 1}", p, s, "head", "head_bn")


def _efficientnet(sd: Dict, prefix: str, p: Mapping, s: Optional[Mapping]) -> None:
    """skinjax ``EfficientNet`` → torchvision's ``features.{stage}.{b}.block``
    keys (the inverse of ``import_efficientnet``). A stage starts where the
    project conv's width changes (every stage of the B0-B7 plans has its own
    width)."""
    f = f"{prefix}features."
    _convbn_seq(sd, f"{f}0", p, s, "stem", "stem_bn")
    stage, b, width = 0, 0, None
    for idx in range(_blocks_of(p, "block")):
        blk, bs = p[f"block{idx}"], _sub(s, f"block{idx}")
        out = _np(blk["project"]["kernel"]).shape[-1]
        stage, b = (stage + 1, 0) if out != width else (stage, b + 1)
        width = out
        base = f"{f}{stage}.{b}.block"
        k = 0
        if "expand" in blk:
            _convbn_seq(sd, f"{base}.0", blk, bs, "expand", "expand_bn")
            k = 1
        _convbn_seq(sd, f"{base}.{k}", blk, bs, "dw", "dw_bn")
        for fc in ("fc1", "fc2"):
            _dense_as_conv1x1(sd, f"{base}.{k + 1}.{fc}", blk["se"][fc])
        _convbn_seq(sd, f"{base}.{k + 2}", blk, bs, "project", "project_bn")
    _convbn_seq(sd, f"{f}{stage + 1}", p, s, "head", "head_bn")


# the features.{i} index of each of VGG16's 13 convs (torchvision's layout)
VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _vgg16(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``VGG16`` → torchvision's keys (the inverse of ``import_vgg16``)."""
    for i, li in enumerate(VGG16_CONVS):
        _conv(sd, f"{prefix}features.{li}", p[f"conv{i}"])
    _linear(sd, f"{prefix}classifier.0", p["fc1"])
    _linear(sd, f"{prefix}classifier.3", p["fc2"])


def _bert(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``NativeBertEncoder`` params → HF torch ``BertModel`` keys
    (the inverse of ``import_torch_bert``; no pooler)."""
    emb = p["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = _np(emb[name]["embedding"])
    _ln(sd, f"{prefix}embeddings.LayerNorm", emb["LayerNorm"])
    layers = p["encoder"]["layer"]
    for i in range(len(layers)):
        b, base = layers[str(i)], f"{prefix}encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _linear(sd, f"{base}.attention.self.{name}", b["attention"]["self"][name])
        _linear(sd, f"{base}.attention.output.dense", b["attention"]["output"]["dense"])
        _ln(sd, f"{base}.attention.output.LayerNorm", b["attention"]["output"]["LayerNorm"])
        _linear(sd, f"{base}.intermediate.dense", b["intermediate"]["dense"])
        _linear(sd, f"{base}.output.dense", b["output"]["dense"])
        _ln(sd, f"{base}.output.LayerNorm", b["output"]["LayerNorm"])


def _gpt2(sd: Dict, prefix: str, p: Mapping) -> None:
    """skinjax ``NativeGPT2Encoder`` params → HF torch ``GPT2Model`` keys
    (the inverse of ``import_torch_gpt2``): Conv1D kernels (out, in) → (in, out)."""

    def conv1d(key, q):
        sd[f"{key}.weight"] = np.ascontiguousarray(_np(q["kernel"]).T)
        sd[f"{key}.bias"] = _np(q["bias"])

    sd[f"{prefix}wte.weight"] = _np(p["wte"]["embedding"])
    sd[f"{prefix}wpe.weight"] = _np(p["wpe"]["embedding"])
    for i in range(len(p["h"])):
        b, base = p["h"][str(i)], f"{prefix}h.{i}"
        _ln(sd, f"{base}.ln_1", b["ln_1"])
        conv1d(f"{base}.attn.c_attn", b["attn"]["c_attn"])
        conv1d(f"{base}.attn.c_proj", b["attn"]["c_proj"])
        _ln(sd, f"{base}.ln_2", b["ln_2"])
        conv1d(f"{base}.mlp.c_fc", b["mlp"]["c_fc"])
        conv1d(f"{base}.mlp.c_proj", b["mlp"]["c_proj"])
    _ln(sd, f"{prefix}ln_f", p["ln_f"])


def text_encoder_state_dict(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A skinjax sentence encoder's params (the ``NativeSentenceTower``'s
    child scope, ``{"bert": …}`` or ``{"gpt2": …}``) → HF torch keys under
    ``prefix``."""
    (scope, p), = tree.items()
    sd: Dict[str, np.ndarray] = {}
    {"bert": _bert, "gpt2": _gpt2}[scope](sd, prefix, p)
    return sd


def _mlp_head(sd: Dict, prefix: str, p: Mapping) -> None:
    _linear(sd, f"{prefix}.0", p["fc1"])
    _ln(sd, f"{prefix}.1", p["norm1"])
    _linear(sd, f"{prefix}.4", p["fc2"])
    _ln(sd, f"{prefix}.5", p["norm2"])
    _linear(sd, f"{prefix}.8", p["fc_out"])


def _encoder(sd: Dict, prefix: str, enc: Mapping, enc_stats: Optional[Mapping],
             nextvit_depths: Optional[Sequence[int]] = None) -> None:
    """A skinjax image tower's tree → the port's keys under ``prefix``,
    dispatched on the tree's own markers."""
    if "stem0_conv" in enc:
        _nextvit(sd, prefix, enc, enc_stats, nextvit_depths)
    elif "norm_final" in enc:
        _densenet(sd, prefix, enc, enc_stats)
    elif "stem_bn" in enc and "se" in enc["block0"]:
        _efficientnet(sd, prefix, enc, enc_stats)
    elif "stem_bn" in enc:
        _mobilenet_v2(sd, prefix, enc, enc_stats)
    elif "conv0" in enc and "fc2" in enc:
        _vgg16(sd, prefix, enc)
    elif "conv" in enc and "fc" in enc:  # custom-cnn
        _conv(sd, f"{prefix}conv", enc["conv"])
        _linear(sd, f"{prefix}fc", enc["fc"])
    elif "stage0_block0_spatial" in enc:
        _davit(sd, prefix, enc)
    elif "down1_norm" in enc or "token_mixer" in enc.get("stage0_block0", {}):
        _caformer(sd, prefix, enc)
    elif "patch_embed1_proj" in enc:
        _coat(sd, prefix, enc)
    elif "patch_norm" in enc:
        _swin(sd, prefix, enc)
    elif "stem" in enc:
        _resnet(sd, prefix, enc, enc_stats)
    elif "pos_embed" in enc:
        _vit(sd, prefix, enc)
    elif "fc_norm" in enc:
        _beit(sd, prefix, enc)
    elif "rel_pos_h" in enc.get("stage0_block0", {}).get("attn", {}):
        _mvit(sd, prefix, enc)
    else:
        raise NotImplementedError(
            "state_dict_from_flax converts ResNet, DaViT, Swin, ViT, BEiT, MViTv2, CAFormer, "
            "CoaT-lite, NextViT, DenseNet, MobileNet-V2, EfficientNet, VGG16 and custom-cnn "
            "image encoders only; "
            f"got an encoder with {sorted(enc)[:4]}..."
        )


def encoder_state_dict(enc: Mapping, stats: Optional[Mapping] = None, prefix: str = "",
                       nextvit_depths: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """A skinjax image tower's params (and batch_stats) → the port tower's
    ``state_dict`` under ``prefix``."""
    sd: Dict[str, np.ndarray] = {}
    _encoder(sd, prefix, enc, stats, nextvit_depths)
    return sd


def _grb(sd: Dict, prefix: str, p: Mapping) -> None:
    _mha(sd, f"{prefix}.attn", p["attn"])
    _linear(sd, f"{prefix}.gate_linear", p["gate_linear"])
    _ln(sd, f"{prefix}.norm", p["norm"])


def _stacked(sd: Dict, prefix: str, p: Mapping) -> None:
    for name, sub in p.items():  # block_{i}
        _grb(sd, f"{prefix}.{name}", sub)


def _residual(sd: Dict, prefix: str, p: Mapping) -> None:
    _mha(sd, f"{prefix}.attn", p["attn"])
    _ln(sd, f"{prefix}.norm", p["norm"])


def _altered(sd: Dict, prefix: str, p: Mapping) -> None:
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    _mha(sd, f"{prefix}.attn", p["attn"])
    sd[f"{prefix}.alpha"] = _np(p["alpha"])
    _linear(sd, f"{prefix}.ffn_in", p["ffn_in"])
    _linear(sd, f"{prefix}.ffn_out", p["ffn_out"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])


def _transformer(sd: Dict, prefix: str, p: Mapping) -> None:
    _mha(sd, f"{prefix}.attention", p["attention"])
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    _linear(sd, f"{prefix}.ff_in", p["ff_in"])
    _linear(sd, f"{prefix}.ff_out", p["ff_out"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])


def _metablock(sd: Dict, prefix: str, p: Mapping) -> None:
    _linear(sd, f"{prefix}.fb.0", p["fb"])
    _ln(sd, f"{prefix}.fb.1", p["fb_norm"])
    _linear(sd, f"{prefix}.gb.0", p["gb"])
    _ln(sd, f"{prefix}.gb.1", p["gb_norm"])


def _metanet(sd: Dict, prefix: str, p: Mapping) -> None:
    _dense_as_conv1x1(sd, f"{prefix}.metanet.0", p["fc1"])
    _dense_as_conv1x1(sd, f"{prefix}.metanet.2", p["fc2"])


def _named_linears(sd: Dict, prefix: str, p: Mapping) -> None:
    """Every Dense of a tree of Denses under its own name."""
    for name, sub in p.items():
        _linear(sd, f"{prefix}.{name}", sub)


def _bilinear(sd: Dict, prefix: str, p: Mapping) -> None:
    for name in ("u", "v", "proj"):
        _linear(sd, f"{prefix}.{name}", p[name])
    _ln(sd, f"{prefix}.norm", p["norm"])


def _one_hot(sd: Dict, prefix: str, p: Mapping) -> None:
    for i, fc in enumerate(("fc0", "fc1", "fc2")):
        _linear(sd, f"{prefix}.{2 * i}", p[fc])


def _tab_transformer(sd: Dict, prefix: str, p: Mapping) -> None:
    for name, sub in p.items():
        if name.startswith("embed"):
            sd[f"{prefix}.{name}.weight"] = _np(sub["embedding"])
        elif name.startswith("encoder"):
            _transformer(sd, f"{prefix}.{name}", sub)
        else:  # numeric_proj, fc_hidden, fc_out
            _linear(sd, f"{prefix}.{name}", sub)


# a skinjax block's tree → the port's keys, by the block's class name
BLOCKS = {
    "GatedAlteredResidualBlock": _grb,
    "StackedGatedResidualBlock": _stacked,
    "ResidualBlock": _residual,
    "AlteredResidualBlock": _altered,
    "TransformerAttentionBlock": _transformer,
    "SimpleAttentionBlock": lambda sd, prefix, p: _mha(sd, f"{prefix}.attention", p["attention"]),
    "MetaBlock": _metablock,
    "MetaNet": _metanet,
    "FeatureModulation": _named_linears,
    "MLPHead": _mlp_head,
    "MLP": _named_linears,
    "BilinearPooling": _bilinear,
    "OneHotMLP": _one_hot,
    "StaticEmbeddingTower": _named_linears,
    "TabTransformer": _tab_transformer,
    "MultiHeadAttention": _mha,
}


def block_state_dict(kind: str, params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """One skinjax block's params (``kind`` its class name, a key of
    ``BLOCKS``) → the port's ``state_dict`` for the same block, under
    ``prefix`` (``"meta_block."``; the module's own keys where empty)."""
    sd: Dict[str, np.ndarray] = {}
    BLOCKS[kind](sd, "_", params)
    return {prefix + k[2:]: v for k, v in sd.items()}


def _tower(params: Mapping) -> str:
    """The scope of a tower that a flax module built inline, auto-named after
    its class (``DenseNet_0``, ``ViT_0``, ``ResNet_0``)."""
    names = [k for k in params if k[:1].isupper() and k.rsplit("_", 1)[-1].isdigit()]
    if len(names) != 1:
        raise ValueError(f"expected one auto-named tower in {sorted(params)}")
    return names[0]


def _baseline_or_sequence(sd: Dict, params: Mapping, batch_stats: Mapping,
                          nextvit_depths: Optional[Sequence[int]]) -> bool:
    """MD-Net, LiwTERM, MetaNet and sequence-fusion trees → the port's keys;
    False for any other tree."""
    if not any(k in params for k in ("meta_net", "visual_proj", "metanet", "img_self")):
        return False
    tower = _tower(params)
    enc, enc_stats = params[tower], batch_stats.get(tower)
    if "meta_net" in params:  # MD-Net
        _densenet(sd, "feature_extractor.", enc, enc_stats, features="")
        _metanet(sd, "meta_net", params["meta_net"])
        _metablock(sd, "meta_block", params["meta_block"])
        _linear(sd, "classifier", params["classifier"])
        return True
    _encoder(sd, "backbone.", enc, enc_stats, nextvit_depths)
    if "visual_proj" in params:  # LiwTERM
        for name, sub in params.items():
            if name != tower:
                (_ln if "norm" in name else _linear)(sd, name, sub)
    elif "metanet" in params:  # MetaNet
        _metanet(sd, "metanet", params["metanet"])
        for name in ("fc1", "fc2", "fc_out"):
            _linear(sd, name, params[name])
        for name in ("norm1", "norm2"):
            _ln(sd, name, params[name])
    else:  # sequence fusion
        for name in ("img_proj", "img_gate", "txt_gate"):
            _linear(sd, name, params[name])
        _one_hot(sd, "text_tower", params["text_tower"])
        for name in ("img_self", "txt_self", "img_cross", "txt_cross"):
            _mha(sd, name, params[name])
        _mlp_head(sd, "head", params["head"])
    return True


def state_dict_from_flax(params: Mapping, batch_stats: Mapping, *,
                         nextvit_depths: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
    """A JAX model's (params, batch_stats) → reference ``state_dict``: a
    ``MultimodalModel``, a baseline (``MDNet``, ``LiwTERM``, ``MetaNetModel``)
    or a ``SequenceFusionModel`` (``nextvit_depths``: a NextViT tree's stage
    depths, where it is not a published tower's)."""
    sd: Dict[str, np.ndarray] = {}
    if _baseline_or_sequence(sd, params, batch_stats, nextvit_depths):
        return sd
    _encoder(sd, "image_encoder.", params["image_encoder"], batch_stats.get("image_encoder"),
             nextvit_depths)
    for name in ("image_projector", "text_projector", "img_gate", "txt_gate",
                 "fc_visual_only", "fc_fusion_proj_feat2output"):
        if name in params:
            _linear(sd, name, params[name])
    if "text_tower" in params:
        if "fc2" in params["text_tower"]:  # the one-hot tower
            _one_hot(sd, "text_fc", params["text_tower"])
        else:  # the static-embedding tower
            _named_linears(sd, "text_tower", params["text_tower"])
    if "text_module" in params:
        tm = params["text_module"]
        if "fc_hidden" in tm:  # TabTransformer
            _tab_transformer(sd, "text_module", tm)
        else:  # a tokens model's sentence tower
            sd.update(text_encoder_state_dict(tm, "text_encoder."))
    for name in ("image_self_attention", "text_self_attention",
                 "image_cross_attention", "text_cross_attention"):
        if name in params:
            _mha(sd, name, params[name])
    for name in ("image_residual", "text_residual"):
        if name in params:
            _grb(sd, name, params[name])
    if "meta_block" in params:
        _metablock(sd, "meta_block", params["meta_block"])
    if "fc_fusion" in params:
        _mlp_head(sd, "fc_fusion", params["fc_fusion"])
    if "fc_after_metablock" in params:
        _mlp_head(sd, "fc_mlp_module_after_metablock_fusion_module", params["fc_after_metablock"])
    return sd


def dynamic_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """A ``skinjax.nas.DynamicCNN``'s params → the state_dict of
    ``skinjax_torch.nas.DynamicCNN``: conv kernels HWIO → OIHW, GroupNorm
    scale/bias → weight/bias, Denses transposed, the cross-attention's
    q/k/v_proj packed, metablock as ``MetaBlock``'s keys."""
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("conv"):
            _conv(sd, name, p)
        elif name.startswith("gn"):
            _ln(sd, name, p)
        elif name == "meta_block":
            _metablock(sd, name, p)
        elif name in ("img_cross", "txt_cross"):
            _mha(sd, name, p)
        else:
            _linear(sd, name, p)
    return sd


def supernet_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """A ``skinjax.nas.SuperNet``'s params → ``skinjax_torch.nas.SuperNet``'s
    state_dict: the raw conv kernels HWIO → OIHW, each Dense transposed, the
    GroupNorm and masked-LayerNorm affines as they are."""
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if isinstance(p, Mapping):
            _linear(sd, name, p)
        elif name.startswith("conv"):
            sd[name] = np.ascontiguousarray(_np(p).transpose(3, 2, 0, 1))
        else:
            sd[name] = _np(p)
    return sd


LSTM_GATES = ("i", "f", "g", "o")  # torch.nn.LSTMCell's order of the stacked gates


def controller_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """A ``skinjax.nas.Controller``'s params → ``skinjax_torch.nas.Controller``'s
    state_dict. flax's ``LSTMCell`` keeps a bias-free Dense per gate on the
    input (``ii``, ``if``, ``ig``, ``io``) and a Dense with bias per gate on
    the hidden state (``hi``, …); ``torch.nn.LSTMCell`` stacks them in (i, f,
    g, o) order as ``weight_ih``/``weight_hh``, with ``bias_ih`` zero."""
    lstm = params["lstm"]
    sd: Dict[str, np.ndarray] = {
        "start_token": _np(params["start_token"]),
        "lstm.weight_ih": np.concatenate([_np(lstm[f"i{g}"]["kernel"]).T for g in LSTM_GATES]),
        "lstm.weight_hh": np.concatenate([_np(lstm[f"h{g}"]["kernel"]).T for g in LSTM_GATES]),
        "lstm.bias_hh": np.concatenate([_np(lstm[f"h{g}"]["bias"]) for g in LSTM_GATES]),
    }
    sd["lstm.bias_ih"] = np.zeros_like(sd["lstm.bias_hh"])
    for name, p in params.items():
        if name.startswith("head_"):
            _linear(sd, f"heads.{name[5:]}", p)
        elif name.startswith("embed_"):
            sd[f"embeds.{name[6:]}.weight"] = _np(p["embedding"])
    return sd


def load_numpy_state_dict(model: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a numpy ``state_dict`` (strict: every key must match)."""
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from ``seed``, drawn on the CPU with one
    ``torch.Generator`` so a seed gives the same weights on any device.

    Convs: He normal over fan-out (torchvision's ResNet init; a depthwise
    conv's fan-out is its channels × kernel area), zero bias. Linears,
    the attention's ``out_proj`` included: LeCun normal (flax's Dense
    default) and zero bias. The packed ``in_proj_weight``: Xavier uniform
    over each D×D block, as the JAX attention draws q/k/v, and zero bias.
    Norms: unit scale, zero shift, running stats (0, 1). Embeddings:
    normal with std dim^-0.5 (flax's Embed default); GPT-2's Conv1D
    normal(0.02) and zero bias (skinjax's GPT-2 initialiser).

    Then the ViT and BEiT towers' own parameters, with skinjax's
    initialisers: the patch embedding LeCun normal (flax's Conv default);
    ``cls_token`` and ``pos_embed`` normal(0.02); ViT's q, k, v and output
    projections Xavier uniform each (skinjax's attention draws them so), its
    qkv bias zero; BEiT's packed qkv Xavier uniform over (C, 3C), its q/v
    biases and relative position bias table zero, ``gamma_1``/``gamma_2``
    1e-5; CoaT's ``cls_token{k}`` normal(0.02); Swin's patch embedding LeCun
    normal and its relative position bias tables normal(0.02). (StarReLU's scalars and
    CAFormer's residual scales keep their constructors' 1 and 0.) MetaNet's
    1×1 convs: LeCun normal, as skinjax's Denses are drawn.
    """
    g = torch.Generator(device="cpu").manual_seed(seed)

    def put(t: torch.Tensor, value: torch.Tensor) -> None:
        t.copy_(value.to(t.dtype))

    def xavier(t: torch.Tensor, fan_in: int, fan_out: int) -> None:
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        put(t, (torch.rand(t.shape, generator=g) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            put(m.weight, torch.randn(m.weight.shape, generator=g) * (2.0 / fan_out) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            put(m.weight, torch.randn(m.weight.shape, generator=g) * m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiheadAttention):
            d = m.embed_dim
            bound = (6.0 / (2 * d)) ** 0.5
            put(m.in_proj_weight, (torch.rand(m.in_proj_weight.shape, generator=g) * 2 - 1) * bound)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.Embedding):
            put(m.weight, torch.randn(m.weight.shape, generator=g) * m.embedding_dim ** -0.5)
        elif isinstance(m, gpt2.Conv1D):
            put(m.weight, torch.randn(m.weight.shape, generator=g) * 0.02)
            m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            if m.bias is not None:  # CAFormer's LayerNorms have none
                m.bias.zero_()
            if not isinstance(m, nn.LayerNorm):
                m.reset_running_stats()
    for m in model.modules():
        if isinstance(m, (vit.PatchEmbed, swin.PatchEmbed)):
            fan_in = m.proj.in_channels * m.proj.kernel_size[0] * m.proj.kernel_size[1]
            put(m.proj.weight, torch.randn(m.proj.weight.shape, generator=g) * fan_in ** -0.5)
        elif isinstance(m, (vit.VisionTransformer, beit.Beit)):
            put(m.cls_token, torch.randn(m.cls_token.shape, generator=g) * 0.02)
            if isinstance(m, vit.VisionTransformer):
                put(m.pos_embed, torch.randn(m.pos_embed.shape, generator=g) * 0.02)
        elif isinstance(m, vit.Attention):
            d = m.proj.in_features
            for i in range(3):
                xavier(m.qkv.weight[i * d:(i + 1) * d], d, d)
            xavier(m.proj.weight, d, d)
        elif isinstance(m, beit.BeitAttention):
            d = m.proj.in_features
            xavier(m.qkv.weight, d, 3 * d)
            for t in (m.q_bias, m.v_bias, m.relative_position_bias_table):
                t.zero_()
        elif isinstance(m, beit.BeitBlock):
            m.gamma_1.fill_(1e-5)
            m.gamma_2.fill_(1e-5)
        elif isinstance(m, swin.WindowAttention):
            t = m.relative_position_bias_table
            put(t, torch.randn(t.shape, generator=g) * 0.02)
        elif isinstance(m, blocks.MetaNet):  # skinjax's Denses: LeCun normal
            for conv in (m.metanet[0], m.metanet[2]):
                put(conv.weight, torch.randn(conv.weight.shape, generator=g)
                    * conv.in_channels ** -0.5)
        elif isinstance(m, coat.CoaTLite):
            for k in range(1, m.num_stages + 1):
                t = getattr(m, f"cls_token{k}")
                put(t, torch.randn(t.shape, generator=g) * 0.02)
    return model
