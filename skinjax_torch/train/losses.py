"""Loss library (counterpart of ``skinjax/train/losses.py``): weighted CE,
focal, soft-target CE, in float32.

  * weighted cross-entropy == ``nn.CrossEntropyLoss(weight=w)``, with torch's
    weighted mean (sum(w_i · ce_i) / sum(w_i));
  * focal loss: alpha gathered per target, (1 − pt)^gamma scaling,
    mean/sum/none reductions;
  * soft-target CE: −Σ t · log_softmax, optionally class-weighted.

Class weights are a call argument (``weighted_loss``) or bound once
(``make_loss_fn``), with the same names as the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -_log_softmax(logits).gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over the batch; with class weights, torch's weighted mean."""
    nll = _nll(logits, labels)
    if class_weights is None:
        return nll.mean()
    w = class_weights.float()[labels.long()]
    return (w * nll).sum() / torch.clamp_min(w.sum(), 1e-12)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               alpha: Optional[torch.Tensor] = None, gamma: float = 2.0,
               reduction: str = "mean") -> torch.Tensor:
    ce = _nll(logits, labels)
    pt = torch.exp(-ce)
    if alpha is not None:
        ce = alpha.float()[labels.long()] * ce
    loss = (1.0 - pt) ** gamma * ce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def soft_target_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor,
                              class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = _log_softmax(logits)
    if class_weights is not None:
        logp = logp * class_weights.float()[None, :]
    return -(soft_targets.float() * logp).sum(dim=-1).mean()


def weighted_loss(name: str, gamma: float = 2.0) -> Callable:
    """Loss with class weights as a call argument: ``fn(logits, labels, w)``."""
    if name in ("cross_entropy", "ce", "weighted_ce"):
        return lambda logits, labels, w: cross_entropy(logits, labels, w)
    if name in ("focal", "focal_loss"):
        return lambda logits, labels, w: focal_loss(logits, labels, w, gamma)
    if name in ("soft_target", "soft_target_ce"):
        return lambda logits, targets, w: soft_target_cross_entropy(logits, targets, w)
    raise ValueError(f"unknown loss '{name}'")


def make_loss_fn(name: str, class_weights=None, gamma: float = 2.0) -> Callable:
    """Loss with the class weights bound: ``fn(logits, labels)``. The weights
    follow the logits' device."""
    fn = weighted_loss(name, gamma)
    cw = None if class_weights is None else torch.as_tensor(class_weights, dtype=torch.float32)

    def loss(logits, labels):
        return fn(logits, labels, None if cw is None else cw.to(logits.device))

    return loss
