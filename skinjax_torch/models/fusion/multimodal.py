"""The multimodal classifier: image tower + metadata tower + fusion stage
(counterpart of ``skinjax/models/fusion/multimodal.py``).

Same configuration strings and the same math per mechanism as the JAX
model, for all eighteen mechanisms.

Like flax, which creates parameters only for the submodules a mechanism
calls, the model holds only the submodules its mechanism uses, so its
``state_dict()`` and the JAX parameter tree convert one to one
(``skinjax_torch.models.weights``). One quirk of that tree is kept:
``metablock`` fuses the raw tower features, but the JAX model computes (and
discards) the image projection first, so its tree, and this model, hold an
``image_projector`` that nothing reads.

Input is NHWC ``(B, H, W, 3)`` and featurized metadata ``(B, vocab_size)``
(with ``text_model_name="static-embedding"``, ``(B, vocab_size)`` model2vec
sentence vectors, which ``StaticEmbeddingTower``, held as ``text_tower``,
projects), or, in tokens mode (``text_module`` a sentence tower,
``text_input_mode "tokens"``), ``{"input_ids", "attention_mask"}`` (B, T)
integer tensors, or, in tabular mode (``text_module`` a ``TabTransformer``,
held as ``text_module``, ``text_input_mode "tabular"``), ``{"categorical"
(B, n_cat) integer, "numerical" (B, n_num) float, optional}``.
The tokens model holds the tower's encoder as ``text_encoder``, as the
reference's sentence model does, so its ``state_dict()`` reads as a
reference sentence checkpoint (``text_encoder.embeddings.…`` for BERT,
``text_encoder.h.…`` for GPT-2); it pools the last hidden state per the
tower's family (``[:, 0]`` or ``[:, -1]``) into ``(B, text_encoder_dim_output)``,
which every mechanism takes as it takes the one-hot tower's output.
``dtype=torch.bfloat16`` runs the model under autocast, the counterpart of
the JAX model's ``dtype=bfloat16``; parameters stay fp32.

CAM (``skinjax_torch.xai.cam``): ``forward(..., capture=True)`` returns
``(logits, aux)``, aux holding what skinjax's holds: ``feature_map`` (the
tower's spatial grid, (B, h, w, C)), ``tokens`` (a tower's token sequence),
``img_feat`` and ``txt_feat`` (the towers' outputs), ``proj_img`` and
``proj_txt`` (their projections). ``feature_delta`` (a tensor of the grid's
shape, or a ``backbones.capture.DeltaProbe``) is added to that grid:
inside a tower that takes ``capture``/``feature_delta`` (found by its
signature, never by catching a ``TypeError``, which would drop the delta and
give an all-zero CAM; ``backbones/capture.py``), else to a tower's NHWC map
before the mean over it.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from skinjax_torch.models.backbones import create_backbone
from skinjax_torch.models.backbones.capture import add_delta
from skinjax_torch.models.fusion.blocks import GatedAlteredResidualBlock, MetaBlock, MLPHead
from skinjax_torch.models.text import OneHotMLP, StaticEmbeddingTower
from skinjax_torch.models.text.bert import pool_hidden
from skinjax_torch.ops.attention import MultiheadAttention

MECHANISMS = (
    "no-metadata",
    "no-metadata-without-mlp",
    "concatenation",
    "crossattention",
    "weighted",
    "gfcam",
    "cross-weights-after-crossattention",
    "metablock",
    "rg-att2fusefeatures",
    "rg-att",
    "att-intramodal",
    "att-intramodal+residual",
    "cross-attention-only",
    "residual+cross-attention-metadados",
    "att-intramodal+residual+cross-attention-metadados",
    "att-intramodal+residual+cross-attention-metadados+rg-att2fusefeatures",
    "att-intramodal+residual+cross-attention-metadados+metablock",
    "att-intramodal+residual+cross-attention-metadados+att-intramodal+residual",
)

_RGATT = "att-intramodal+residual+cross-attention-metadados"
# RG-ATT and its three extensions: self-attention → gated residual → cross-attention
_RGATT_FAMILY = tuple(m for m in MECHANISMS if m.startswith(_RGATT))
_CROSS_FAMILY = ("crossattention", "gfcam", "cross-weights-after-crossattention")
_NO_TEXT = ("no-metadata", "no-metadata-without-mlp")
_RAW_FEATURES = ("metablock", "no-metadata-without-mlp")  # fused without projections
_SELF_ATTENTION = ("att-intramodal", "att-intramodal+residual", *_CROSS_FAMILY, *_RGATT_FAMILY)
_CROSS_ATTENTION = (*_CROSS_FAMILY, "cross-attention-only", "residual+cross-attention-metadados",
                    *_RGATT_FAMILY)
_TEXT_RESIDUAL = ("rg-att", "att-intramodal+residual", "residual+cross-attention-metadados",
                  *_RGATT_FAMILY)
_GATES = ("weighted", "gfcam", "cross-weights-after-crossattention")
_FEAT2OUTPUT = ("rg-att2fusefeatures", _RGATT + "+rg-att2fusefeatures", _RGATT + "+metablock")


class FusionOps(NamedTuple):
    """The primitives the fusion stage is built from, each addressed by the
    name of the submodule that holds its weights. The model's own are its
    modules; the fused serving engine passes the CUDA kernels instead."""

    attend: Callable  # (name, q, kv) -> seq-1 attention, (B, D)
    residual: Callable  # (name, q, kv) -> gated residual block, (B, D)
    gate: Callable  # (name, x) -> sigmoid(linear(x)), (B, D)
    film: Callable  # (name, v, u) -> MetaBlock, (B, v_dim)


def autocast_to(dtype: Optional[torch.dtype], device: torch.device):
    """Autocast to a model's compute dtype on ``device``, or nothing for
    fp32 (the counterpart of a flax module's ``dtype``)."""
    if dtype is None or dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def takes_cam(tower: nn.Module) -> bool:
    """Whether the tower's forward takes ``capture`` and ``feature_delta``."""
    params = inspect.signature(type(tower).forward).parameters
    return "capture" in params and "feature_delta" in params


def _head_name(mech: str) -> str:
    if mech == "no-metadata-without-mlp":
        return "fc_visual_only"
    if mech == "metablock":
        return "fc_mlp_module_after_metablock_fusion_module"
    if mech in _FEAT2OUTPUT:
        return "fc_fusion_proj_feat2output"
    return "fc_fusion"


class MultimodalModel(nn.Module):
    def __init__(
        self,
        num_classes: int,
        num_heads: int = 8,
        cnn_model_name: str = "resnet-50",
        text_model_name: str = "one-hot-encoder",
        common_dim: int = 512,
        text_encoder_dim_output: int = 512,
        vocab_size: int = 91,
        attention_mechanism: str = "concatenation",
        dropout_rate: float = 0.5,
        dtype: Optional[torch.dtype] = None,
        text_module: Optional[nn.Module] = None,
        text_input_mode: str = "features",
        *,
        device=None,
    ):
        super().__init__()
        mech = attention_mechanism
        if mech not in MECHANISMS:
            raise ValueError(f"Attention mechanism '{mech}' not implemented. Known: {MECHANISMS}")
        if text_input_mode not in ("features", "tokens", "tabular"):
            raise ValueError(f"text_input_mode '{text_input_mode}': one of features, tokens, "
                             "tabular")
        if (text_input_mode != "features") != (text_module is not None):
            raise ValueError("tokens mode takes a text_module (a sentence tower), tabular mode "
                             "a TabTransformer, features mode none")
        if text_module is None and text_model_name not in ("one-hot-encoder", "static-embedding"):
            raise ValueError(
                f"text tower '{text_model_name}' is not wired into MultimodalModel; use "
                "one-hot-encoder / static-embedding, or pass text_module= (a sentence tower "
                "or a TabTransformer)")
        if text_input_mode == "tokens":
            text_encoder_dim_output = text_module.hidden_size
        elif text_input_mode == "tabular":
            text_encoder_dim_output = text_module.out_dim
        self.num_classes = num_classes
        self.text_input_mode = text_input_mode
        self.common_dim = common_dim
        self.vocab_size = vocab_size
        self.attention_mechanism = mech
        self.head_name = _head_name(mech)
        self.dtype = dtype

        self.image_encoder, self.cnn_dim_output = create_backbone(cnn_model_name, device=device,
                                                                  common_dim=common_dim)
        if mech != "no-metadata-without-mlp":
            self.image_projector = nn.Linear(self.cnn_dim_output, common_dim, device=device)
        if mech in _NO_TEXT:
            pass
        elif text_input_mode == "tokens":
            self.text_encoder = text_module.encoder
            self.text_pool = text_module.pool
        elif text_input_mode == "tabular":
            self.text_module = text_module
        elif text_model_name == "static-embedding":
            self.text_tower = StaticEmbeddingTower(vocab_size, text_encoder_dim_output,
                                                   device=device)
        else:
            self.text_fc = OneHotMLP(vocab_size, text_encoder_dim_output, device=device)
        if mech not in (*_NO_TEXT, "metablock"):
            self.text_projector = nn.Linear(text_encoder_dim_output, common_dim, device=device)

        mha = lambda: MultiheadAttention(common_dim, num_heads, device=device)  # noqa: E731
        if mech in _SELF_ATTENTION:
            self.image_self_attention = mha()
            self.text_self_attention = mha()
        if mech in _CROSS_ATTENTION:
            self.image_cross_attention = mha()
            self.text_cross_attention = mha()
        if mech in _GATES:
            self.img_gate = nn.Linear(common_dim, common_dim, device=device)
            self.txt_gate = nn.Linear(common_dim, common_dim, device=device)
        # 8 heads whatever num_heads is, as in the JAX model; at seq-1 the head
        # count changes nothing
        if mech in (*_TEXT_RESIDUAL, "rg-att2fusefeatures"):
            self.image_residual = GatedAlteredResidualBlock(common_dim, device=device)
        if mech in _TEXT_RESIDUAL:
            self.text_residual = GatedAlteredResidualBlock(common_dim, device=device)
        if mech == "metablock":  # raw features: V the image tower's, U the metadata tower's
            self.meta_block = MetaBlock(text_encoder_dim_output, self.cnn_dim_output,
                                        device=device)
        elif mech == _RGATT + "+metablock":  # on the cross-attended pair
            self.meta_block = MetaBlock(common_dim, common_dim, device=device)

        if self.head_name == "fc_fusion":
            width = common_dim if mech == "no-metadata" else 2 * common_dim
            self.fc_fusion = MLPHead(width, common_dim, num_classes, dropout_rate, device=device)
        elif self.head_name == "fc_visual_only":
            self.fc_visual_only = nn.Linear(self.cnn_dim_output, num_classes, device=device)
        elif self.head_name == "fc_fusion_proj_feat2output":
            self.fc_fusion_proj_feat2output = nn.Linear(common_dim, num_classes, device=device)
        else:
            self.fc_mlp_module_after_metablock_fusion_module = MLPHead(
                self.cnn_dim_output, common_dim, num_classes, 0.3, device=device)

    def autocast(self, device: torch.device):
        """Autocast to the model's compute dtype, or nothing for fp32."""
        return autocast_to(self.dtype, device)

    def text_features(self, metadata) -> torch.Tensor:
        """The metadata tower's output (B, text_encoder_dim_output): the
        one-hot MLP or the static-embedding tower on features, the pooled
        sentence encoder on tokens, or TabTransformer on tabular columns."""
        if self.text_input_mode == "tokens":
            hidden = self.text_encoder(metadata["input_ids"], metadata.get("attention_mask"))
            return pool_hidden(hidden, self.text_pool)
        if self.text_input_mode == "tabular":
            return self.text_module(metadata["categorical"], metadata.get("numerical"))
        if hasattr(self, "text_tower"):
            return self.text_tower(metadata)
        return self.text_fc(metadata)

    def image_features(self, image: torch.Tensor, aux: Optional[dict] = None,
                       feature_delta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The image tower's feature (B, cnn_dim): a map's mean, a token
        sequence's CLS token, or the tower's own pooling. With ``aux`` (a
        dict) or ``feature_delta``, the CAM grid as the module docstring
        says."""
        img = None
        if (aux is not None or feature_delta is not None) and takes_cam(self.image_encoder):
            img, fmap = self.image_encoder(image, capture=True, feature_delta=feature_delta)
            if aux is not None:
                aux["feature_map"] = fmap
        if img is None:
            img = self.image_encoder(image)
        if img.dim() == 4:  # NHWC map → GAP
            img = add_delta(img, feature_delta)
            if aux is not None:
                aux["feature_map"] = img
            img = img.mean(dim=(1, 2))
        elif img.dim() == 3:  # token sequence → CLS
            if aux is not None:
                aux["tokens"] = img
            img = img[:, 0]
        if aux is not None:
            aux["img_feat"] = img
        return img

    def features(self, image: torch.Tensor, metadata, aux: Optional[dict] = None,
                 feature_delta: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The fusion stage's inputs (img, txt): both towers' outputs,
        projected to common_dim unless the mechanism fuses the raw features
        (``metablock``: (B, cnn_dim) and (B, text_encoder_dim_output);
        ``no-metadata-without-mlp``: the image feature alone). ``txt`` is
        None for the two mechanisms without metadata. ``aux`` and
        ``feature_delta``: the CAM's, as ``forward`` takes them."""
        mech = self.attention_mechanism
        with self.autocast(image.device):
            img = self.image_features(image, aux, feature_delta)
            txt = None if mech in _NO_TEXT else self.text_features(metadata)
            if aux is not None and txt is not None:
                aux["txt_feat"] = txt
            if aux is not None and mech == "metablock":  # skinjax projects it all the same
                aux["proj_img"] = self.image_projector(img)
            if mech not in _RAW_FEATURES:
                img = self.image_projector(img)
                if txt is not None:
                    txt = self.text_projector(txt)
                if aux is not None:
                    aux["proj_img"] = img
                    if txt is not None:
                        aux["proj_txt"] = txt
        return img, txt

    def module_ops(self) -> FusionOps:
        """The primitives as this model's submodules."""

        def seq1(name, q, kv):  # the named attention or residual block, on (B, D)
            kv = kv[:, None]
            return getattr(self, name)(q[:, None], kv, kv)[:, 0]

        return FusionOps(seq1, seq1, lambda name, x: torch.sigmoid(getattr(self, name)(x)),
                         lambda name, v, u: getattr(self, name)(v, u))

    def fuse(self, img: torch.Tensor, txt: Optional[torch.Tensor],
             ops: Optional[FusionOps] = None) -> torch.Tensor:
        """The fusion stage on what ``features`` gives → the head's input."""
        attend, residual, gate, film = ops or self.module_ops()
        mech = self.attention_mechanism
        cat = lambda a, b: torch.cat([a, b], dim=-1)  # noqa: E731
        if mech in _NO_TEXT:
            return img
        if mech == "metablock":
            return film("meta_block", img, txt)
        if mech == "concatenation":
            return cat(img, txt)
        if mech == "weighted":
            return cat(gate("img_gate", img) * img, gate("txt_gate", txt) * txt)
        if mech == "cross-attention-only":
            return cat(attend("image_cross_attention", img, txt),
                       attend("text_cross_attention", txt, img))
        if mech == "rg-att2fusefeatures":  # the metadata queries the image
            return residual("image_residual", txt, img)
        if mech == "rg-att":
            return cat(residual("image_residual", img, txt), residual("text_residual", txt, img))
        if mech == "residual+cross-attention-metadados":  # residual blocks with kv = q
            img_r, txt_r = residual("image_residual", img, img), residual("text_residual", txt, txt)
            return cat(attend("image_cross_attention", img_r, txt_r),
                       attend("text_cross_attention", txt_r, img_r))
        img_att = attend("image_self_attention", img, img)
        txt_att = attend("text_self_attention", txt, txt)
        if mech == "att-intramodal":
            return cat(img_att, txt_att)
        if mech == "att-intramodal+residual" or mech in _RGATT_FAMILY:
            img_att = residual("image_residual", img, img_att)
            txt_att = residual("text_residual", txt, txt_att)
            if mech == "att-intramodal+residual":
                return cat(img_att, txt_att)
        img_x = attend("image_cross_attention", img_att, txt_att)
        txt_x = attend("text_cross_attention", txt_att, img_att)
        if mech in ("crossattention", _RGATT):
            return cat(img_x, txt_x)
        if mech == _RGATT + "+rg-att2fusefeatures":
            return residual("image_residual", txt_x, img_x)
        if mech == _RGATT + "+metablock":
            return film("meta_block", img_x, txt_x)
        if mech == _RGATT + "+att-intramodal+residual":
            # the same self-attention and residual modules a second time
            img_a2 = attend("image_self_attention", img_x, img_x)
            txt_a2 = attend("text_self_attention", txt_x, txt_x)
            return cat(residual("image_residual", img_x, img_a2),
                       residual("text_residual", txt_x, txt_a2))
        a_img, a_txt = gate("img_gate", img_x), gate("txt_gate", txt_x)
        if mech == "gfcam":
            return cat(a_img * img_x, a_txt * txt_x)
        return cat(a_txt * img_x, a_img * txt_x)  # swapped gates

    def forward(self, image: torch.Tensor, metadata, *, capture: bool = False,
                feature_delta: Optional[torch.Tensor] = None):
        """image (B, H, W, 3) NHWC, metadata (B, vocab_size), the token
        dict or the tabular dict → logits (B, num_classes), or with
        ``capture`` (logits, aux); ``feature_delta`` is added to the CAM
        grid (the module docstring)."""
        aux = {} if capture else None
        img, txt = self.features(image, metadata, aux, feature_delta)
        with self.autocast(image.device):
            logits = getattr(self, self.head_name)(self.fuse(img, txt))
        return (logits, aux) if capture else logits
