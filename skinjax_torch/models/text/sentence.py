"""Sentence towers for the LLM-generated-sentence datasets (counterpart of
``skinjax/models/text/sentence.py``).

``build_sentence_tower`` builds the native tower for a reference text-encoder
name (the ``bert-base-uncased`` and ``gpt2`` families): ``NativeBertEncoder``
pooled at ``[:, 0]`` or ``NativeGPT2Encoder`` pooled at ``[:, -1]``, under
``NativeSentenceTower``. Given a local directory it reads ``config.json``
with ``json`` and, where there is one, ``pytorch_model.bin`` with
``torch.load(weights_only=True)`` (HF's torch checkpoint; no
``transformers``, no ``safetensors``). Without weights it warns, as skinjax
does, and the tower is drawn at random (from ``config.json``, or from
BERT-base's / GPT-2 small's defaults). The loaded weights ride on the tower
as ``pretrained_state_dict``; ``graft_pretrained`` loads them into the
tower's encoder, which ``create_model`` does after drawing the model's
other weights. skinjax's ``native=False`` route (``HFSentenceTower``, a
wrapped ``transformers`` model) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Dict, Optional

import torch
from torch import nn

from skinjax_torch.models.text.bert import (
    NativeBertEncoder,
    NativeSentenceTower,
    config_from_hf,
    read_config,
)
from skinjax_torch.models.text.gpt2 import NativeGPT2Encoder, config_from_hf_gpt2

WEIGHTS_FILE = "pytorch_model.bin"
# heads HF keeps beside a BertModel/GPT2Model in its checkpoints, and buffers
# that are not parameters; none is part of the encoder
_DROP = ("pooler.", "cls.", "lm_head.", "embeddings.position_ids", "embeddings.token_type_ids")


def is_sentence_model(text_model_name: str) -> bool:
    """The reference's sentence-encoder names: the BERT and GPT-2 families."""
    return text_model_name.startswith(("bert", "gpt2"))


def _encoder_state_dict(raw: Dict[str, torch.Tensor], gpt2: bool) -> Dict[str, torch.Tensor]:
    """A HF checkpoint's tensors as the encoder's keys: the ``bert.`` /
    ``transformer.`` prefix of a model with a head dropped, the heads and
    buffers dropped, and the LayerNorm ``gamma``/``beta`` of older BERT
    checkpoints renamed ``weight``/``bias``, as HF's loader does."""
    prefix = "transformer." if gpt2 else "bert."
    out = {}
    for k, v in raw.items():
        if k.startswith(prefix):
            k = k[len(prefix):]
        if k.startswith(_DROP) or (gpt2 and k.endswith((".attn.bias", ".attn.masked_bias"))):
            continue
        if k.endswith(".gamma"):
            k = k[:-len("gamma")] + "weight"
        elif k.endswith(".beta"):
            k = k[:-len("beta")] + "bias"
        out[k] = v
    return out


def build_sentence_tower(model_name: str, local_path: Optional[str] = None,
                         native: bool = True) -> NativeSentenceTower:
    """The native sentence tower for ``model_name`` (``bert*`` or ``gpt2*``),
    with the weights of ``local_path`` where it holds them."""
    if not native:
        raise NotImplementedError(
            "the transformers-wrapped sentence tower (native=False, skinjax's HFSentenceTower) "
            "is not ported to PyTorch; ROADMAP.md lists when it comes")
    gpt2 = model_name.startswith("gpt2")
    config, state = None, None
    weights = os.path.join(local_path, WEIGHTS_FILE) if local_path else None
    try:
        if local_path is None:
            raise FileNotFoundError("no local path given")
        config = read_config(local_path)
        state = _encoder_state_dict(torch.load(weights, map_location="cpu", weights_only=True),
                                    gpt2)
    except (OSError, ValueError, RuntimeError, pickle.UnpicklingError) as e:
        warnings.warn(
            f"Could not load pretrained weights for {model_name!r} ({type(e).__name__}: {e}); "
            "falling back to RANDOM init — sentence-tower accuracy will not match published "
            f"results. Provide local_path (a directory with config.json and {WEIGHTS_FILE}) "
            "for real weights.", stacklevel=2)
    config = config or {}  # read before a missing weights file, where there is one
    if gpt2:
        encoder = NativeGPT2Encoder(**config_from_hf_gpt2(config))
    else:
        encoder = NativeBertEncoder(**config_from_hf(config))
    tower = NativeSentenceTower(encoder, pool="last" if gpt2 else "cls")
    tower.pretrained_state_dict = state
    if state is not None:
        graft_pretrained(encoder, tower)
    return tower


def graft_pretrained(encoder: nn.Module, tower: NativeSentenceTower) -> nn.Module:
    """Load the weights ``build_sentence_tower`` read into ``encoder`` (the
    tower's own, or the one a model adopted from it); strict, so that every
    key must match. A tower drawn at random leaves it as it is."""
    state = getattr(tower, "pretrained_state_dict", None)
    if state is not None:
        encoder.load_state_dict(state)
    return encoder
