"""Model factory (counterpart of ``skinjax/models/factory.py``): the
reference's model-select switch. ``multimodal`` with the one-hot metadata
tower builds the port's ``MultimodalModel`` with the requested backbone and
fusion, initialised from a seed; the baselines and the sentence towers are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from skinjax_torch.models.fusion.multimodal import MultimodalModel
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
) -> MultimodalModel:
    """A new model with random weights drawn from ``seed`` (``init_weights``)."""
    name = model_name.lower()
    if name in ("mdnet", "liwterm", "metanet"):
        raise NotImplementedError(
            f"the {name} baseline is not ported to PyTorch yet; ROADMAP.md lists when it comes")
    if text_model_name != "one-hot-encoder":
        raise NotImplementedError(
            f"text tower '{text_model_name}' is not ported to PyTorch yet; "
            "ROADMAP.md lists when it comes")
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
