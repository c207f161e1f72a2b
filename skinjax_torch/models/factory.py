"""Model factory (counterpart of ``skinjax/models/factory.py``): the
reference's model-select switch. ``mdnet``, ``liwterm`` and ``metanet``
build the baselines with skinjax's choice of tower (DenseNet-169 unless the
name holds ``densenet``; ViT-large unless it starts with ``vit``; the
given tower), the metadata width ``vocab_size``. Anything else builds the
port's ``MultimodalModel`` with the requested backbone and fusion: with the
one-hot metadata tower; with ``text_model_name="static-embedding"``, the
static-embedding tower over ``vocab_size``-wide sentence vectors; or, for a
``bert*`` / ``gpt2*`` text model, in tokens mode with the sentence tower of
``build_sentence_tower`` (its weights from ``text_weights_dir`` where given,
grafted over the seed's draw; random otherwise, with skinjax's warning).
Every model is initialised from a seed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from skinjax_torch.models.baselines import LiwTERM, MDNet, MetaNetModel
from skinjax_torch.models.fusion.multimodal import MultimodalModel
from skinjax_torch.models.text.sentence import (
    build_sentence_tower,
    graft_pretrained,
    is_sentence_model,
)
from skinjax_torch.models.weights import init_weights


def create_model(
    *,
    num_classes: int,
    model_name: str = "multimodal",
    cnn_model_name: str = "resnet-50",
    text_model_name: str = "one-hot-encoder",
    attention_mechanism: str = "concatenation",
    num_heads: int = 8,
    common_dim: int = 512,
    vocab_size: int = 91,
    dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    text_weights_dir: Optional[str] = None,
) -> nn.Module:
    """A new model with random weights drawn from ``seed`` (``init_weights``)."""
    name = model_name.lower()
    if name == "mdnet":
        return init_weights(MDNet(
            num_classes=num_classes, meta_dim=vocab_size,
            cnn_model_name=cnn_model_name if "densenet" in cnn_model_name else "densenet169",
            dtype=dtype), seed)
    if name == "liwterm":
        return init_weights(LiwTERM(
            num_classes=num_classes, meta_dim=vocab_size,
            image_encoder=(cnn_model_name if cnn_model_name.startswith("vit")
                           else "vit_large_patch16_224"), dtype=dtype), seed)
    if name == "metanet":
        return init_weights(MetaNetModel(num_classes=num_classes, meta_dim=vocab_size,
                                         image_encoder=cnn_model_name, dtype=dtype), seed)
    if is_sentence_model(text_model_name):
        tower = build_sentence_tower(text_model_name, text_weights_dir)
        model = init_weights(MultimodalModel(
            num_classes=num_classes,
            num_heads=num_heads,
            cnn_model_name=cnn_model_name,
            text_model_name=text_model_name,
            text_module=tower,
            text_input_mode="tokens",
            common_dim=common_dim,
            vocab_size=vocab_size,
            attention_mechanism=attention_mechanism,
            dtype=dtype,
        ), seed)
        if hasattr(model, "text_encoder"):
            graft_pretrained(model.text_encoder, tower)
        return model
    model = MultimodalModel(
        num_classes=num_classes,
        num_heads=num_heads,
        cnn_model_name=cnn_model_name,
        text_model_name=text_model_name,
        common_dim=common_dim,
        vocab_size=vocab_size,
        attention_mechanism=attention_mechanism,
        dtype=dtype,
    )
    return init_weights(model, seed)
