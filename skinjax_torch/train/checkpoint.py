"""Checkpoints for mid-training resume (counterpart of
``skinjax/train/checkpoint.py``, which writes orbax trees).

A checkpoint is a directory holding ``state.pt``, a ``torch.save`` of the
model's ``state_dict`` (parameters and BatchNorm buffers), the optimizer's
``state_dict`` (Adam moments and step, the learning rate) and the train step
counter. Tensors are saved from the device and restored onto the model's
device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

FILE = "state.pt"


def save_checkpoint(path: str, state, model_state: Optional[Mapping[str, torch.Tensor]] = None,
                    step: Optional[int] = None) -> None:
    """Write ``state`` (a ``TrainState``) to ``path/state.pt``. ``model_state``
    and ``step`` replace the live model's and step counter (a best-weights
    snapshot saved with the live optimizer state)."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": dict(model_state if model_state is not None else state.model.state_dict()),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step if step is None else step),
    }
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILE))  # a reader sees the old file or the new one


def load_checkpoint(path: str, device) -> Dict[str, Any]:
    """The saved dict, its tensors on ``device``."""
    return torch.load(os.path.join(path, FILE), map_location=device, weights_only=True)


def restore_checkpoint(path: str, state) -> None:
    """Load ``path`` into ``state``'s model, optimizer and step, in place."""
    saved = load_checkpoint(path, next(state.model.parameters()).device)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
