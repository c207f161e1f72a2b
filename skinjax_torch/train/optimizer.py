"""Optimizer, LR schedule and freeze policy (counterpart of
``skinjax/train/optimizer.py``).

Adam with torch-style L2 weight decay (added to the gradient before the
moments): ``torch.optim.Adam(weight_decay=wd)``, which is what skinjax's
``add_decayed_weights → adam`` chain computes. ``PlateauScheduler`` is
torch's ReduceLROnPlateau(min) logic, stepped on the host at epoch ends; its
LR goes into the optimizer's ``param_groups`` (``set_learning_rate``).

Freeze policy, over ``named_parameters()``: frozen_weights /
unfrozen_weights / last_layer_unfrozen_weights / partial. A frozen parameter
gets ``requires_grad_(False)``, so autograd never builds the frozen part's
backward, and it is left out of the optimizer. BatchNorm statistics still
update in train mode, as in skinjax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

# last-stage name markers per backbone family, used by "partial" mode:
# skinjax's markers, with its ViT/BEiT block names "block11"/"block23" as the
# port's timm names "blocks.11."/"blocks.23."
LAST_STAGE_MARKERS = (
    "layer4",      # resnet
    "block{last}", # resolved dynamically
    "trans2",      # densenet tail
    "norm_final",
    "head",        # mobilenet/efficientnet head conv
    "blocks.11.",  # vit_base last block
    "blocks.23.",  # vit_large last block
)

# skinjax's markers as it has them, applied to skinjax's own scope names by the
# towers that map their parameters to those (``flax_scopes()``: NextViT and
# the CNN zoo, whose torchvision/timm names differ from skinjax's, so that
# substrings of the port's names would select another set: skinjax's
# "layer4" hits DenseNet's block{i}_layer4 in every dense block, the port's
# denselayer5)
FLAX_MARKERS = ("layer4", "trans2", "norm_final", "head", "block11", "block23")

FREEZE_MODES = ("unfrozen_weights", "frozen_weights", "last_layer_unfrozen_weights", "partial")


def trainable_mask(model: nn.Module, mode: str,
                   frozen_prefixes: Sequence[str] = ("image_encoder",)) -> Dict[str, bool]:
    """Parameter name → trainable. ``mode`` applies to the parameters under
    ``frozen_prefixes`` (the backbone); everything else is always trainable.
    ``last_layer_unfrozen_weights`` keeps the module that owns the last
    backbone parameter (in creation order) trainable. ``partial`` trains the
    parameters a last-stage marker names: inside a tower with
    ``flax_scopes()``, those whose skinjax scope holds one of
    ``FLAX_MARKERS``; elsewhere, those whose own name holds one of
    ``LAST_STAGE_MARKERS``."""
    if mode not in FREEZE_MODES:
        raise ValueError(f"Invalid backbone_train_mode: {mode}")
    names = [n for n, _ in model.named_parameters()]

    def inside(n):
        return any(n.startswith(p) for p in frozen_prefixes)

    last_module = None
    if mode == "last_layer_unfrozen_weights":
        ordered = [n for n in names if inside(n)]
        if ordered:
            last_module = ordered[-1].rsplit(".", 1)[0]

    scopes = {}  # a scoped tower's name prefix → {parameter prefix: skinjax scope}
    for name, m in model.named_modules():
        if hasattr(m, "flax_scopes"):
            scopes[f"{name}."] = {f"{name}.{p}": f for p, f in m.flax_scopes()}

    def marked(n):
        tower = next((t for t in scopes if n.startswith(t)), None)
        if tower is None:
            return any(m in n for m in LAST_STAGE_MARKERS if "{" not in m)
        scope = next(f for p, f in scopes[tower].items() if n.startswith(p))
        return any(m in scope for m in FLAX_MARKERS)

    def leaf(n):
        if not inside(n) or mode == "unfrozen_weights":
            return True
        if mode == "frozen_weights":
            return False
        if mode == "last_layer_unfrozen_weights":
            return last_module is not None and n.startswith(last_module + ".")
        return marked(n)

    return {n: leaf(n) for n in names}


def apply_mask(model: nn.Module, mask: Dict[str, bool]) -> None:
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])


def make_optimizer(model: nn.Module, learning_rate: float = 5e-5,
                   weight_decay: float = 1e-4) -> torch.optim.Adam:
    """Adam with L2 weight decay over the model's trainable parameters."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class PlateauScheduler:
    """torch ReduceLROnPlateau(min) parity: if the val metric fails to
    improve for ``patience`` epochs, lr *= factor."""

    lr: float
    factor: float = 0.1
    patience: int = 2
    min_lr: float = 0.0
    threshold: float = 1e-4  # torch default (rel mode) — improvement margin
    best: Optional[float] = None
    num_bad: int = 0

    def step(self, value: float) -> float:
        if self.best is None or value < self.best * (1 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
