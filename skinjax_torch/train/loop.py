"""The fold loop (counterpart of ``skinjax/train/loop.py``): the reference's
``train_process`` around eager PyTorch steps.

Per epoch: weighted-resampled batches (``epoch_batches``, the same index
matrices as skinjax for the same seed and epoch) → train step (augment →
forward → loss → backward → Adam) → full validation pass → plateau LR step →
early stopping on the configured metric. Returns the state holding the best
weights, the metrics of a re-evaluation of them, and the loss history.

The model comes in built and initialised; the loop moves it to
``TrainConfig.device`` (``cuda`` unless the caller asks for the CPU), in
``channels_last`` on the card, and trains it in place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skinjax_torch.data.pipeline import prefetch_batches
from skinjax_torch.data.sampling import compute_class_weights, epoch_batches
from skinjax_torch.train import checkpoint as ckpt
from skinjax_torch.train.early_stopping import EarlyStopping
from skinjax_torch.train.losses import make_loss_fn
from skinjax_torch.train.metrics import classification_metrics
from skinjax_torch.train.optimizer import (
    PlateauScheduler,
    apply_mask,
    make_optimizer,
    set_learning_rate,
    trainable_mask,
)
from skinjax_torch.train.steps import TrainState, make_eval_step, make_train_step_weighted

# the port's metadata towers: the one-hot MLP, a tokens model's sentence
# encoder, the static-embedding tower (and sequence fusion's one-hot tower)
# and a tabular model's TabTransformer (skinjax: text_tower / text_module)
TEXT_PREFIXES = ("text_fc", "text_encoder", "text_tower", "text_module")


@dataclasses.dataclass
class TrainConfig:
    num_epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 5e-5
    weight_decay: float = 1e-4
    loss: str = "weighted_ce"
    focal_gamma: float = 2.0
    early_stopping_patience: int = 10
    early_stopping_delta: float = 0.01
    early_stopping_metric: str = "val_loss"
    plateau_factor: float = 0.1
    plateau_patience: int = 2
    unfreeze_weights: str = "unfrozen_weights"
    # freeze mode for the text tower; None leaves the one-hot tower trainable
    # and makes a sentence tower follow unfreeze_weights, binarised, as in
    # skinjax (text_mode); an explicit mode overrides
    text_train_mode: Optional[str] = None
    weighted_sampling: bool = True
    augment: bool = True
    augment_recipe: str = "default"  # or "sentence"
    seed: int = 42
    image_dtype: str = "bfloat16"
    log_every: int = 0  # batches; 0 = epoch level only
    device: str = "cuda"


def _dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.image_dtype == "bfloat16" else torch.float32


def _to_device(batch: Dict, device: torch.device) -> Dict:
    """A host batch's arrays as tensors on ``device``; a dict (a sentence
    dataset's token metadata, a tabular dataset's columns) is moved leaf by
    leaf, integer leaves staying integral."""
    return {k: _to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _snapshot(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An on-device copy of the parameters and buffers."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def evaluate(
    eval_step: Callable,
    state: TrainState,
    source,
    batch_size: int,
    num_classes: int,
    loss_fn: Optional[Callable] = None,
    device="cuda",
) -> Tuple[Dict, np.ndarray, np.ndarray, np.ndarray, float]:
    """One pass over ``source`` in order (the last batch may be partial).

    Returns (metrics, labels, preds, probs, mean_loss); the mean loss is the
    loss function over all logits at once."""
    device = torch.device(device)
    n = len(source)
    logits = []
    for start in range(0, n, batch_size):
        batch = _to_device(source.batch(np.arange(start, min(start + batch_size, n))), device)
        logits.append(eval_step(state, batch["image"], batch["metadata"]))
    logits_out = torch.cat(logits).cpu() if logits else torch.zeros((0, num_classes))
    probs_out = torch.softmax(logits_out, dim=-1).numpy()
    labels = np.asarray(source.labels[:n])
    preds = probs_out.argmax(axis=1)
    metrics = classification_metrics(labels, preds, probs_out, num_classes)
    mean_loss = (float(loss_fn(logits_out, torch.as_tensor(labels, dtype=torch.long)))
                 if loss_fn is not None else float("nan"))
    return metrics, labels, preds, probs_out, mean_loss


def text_mode(model: torch.nn.Module, cfg: TrainConfig) -> Optional[str]:
    """The text tower's freeze mode: ``cfg.text_train_mode`` when set; else,
    for a tokens model, ``unfreeze_weights`` binarised as skinjax does (the
    reference sets requires_grad=False on the whole sentence tower in every
    mode but ``unfrozen_weights``): ``unfrozen_weights`` or ``frozen_weights``;
    else None (the one-hot, static-embedding and TabTransformer towers
    train, as the reference's never touch requires_grad)."""
    if cfg.text_train_mode is not None:
        return cfg.text_train_mode
    if getattr(model, "text_input_mode", "features") == "tokens":
        return ("unfrozen_weights" if cfg.unfreeze_weights == "unfrozen_weights"
                else "frozen_weights")
    return None


def build_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    """Move the model to the device, apply the freeze masks, build Adam."""
    device = torch.device(cfg.device)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    mask = trainable_mask(model, cfg.unfreeze_weights)
    mode = text_mode(model, cfg)
    if mode and mode != "unfrozen_weights":
        text_mask = trainable_mask(model, mode, frozen_prefixes=TEXT_PREFIXES)
        mask = {k: mask[k] and text_mask[k] for k in mask}
    apply_mask(model, mask)
    return TrainState(model, make_optimizer(model, cfg.learning_rate, cfg.weight_decay))


def train_process(
    model,
    train_source,
    val_source,
    num_classes: int,
    config: TrainConfig = TrainConfig(),
    tracker=None,
    fold_num: int = 0,
    resume_dir: Optional[str] = None,
    mesh=None,
) -> Tuple[TrainState, Dict, Dict[str, List[float]]]:
    """``resume_dir``: if set, a checkpoint (model, optimizer, step) and the
    loop's progress are written there each epoch, and training resumes from
    the latest one. ``mesh`` (data/model parallel training) is not ported."""
    if mesh is not None:
        raise NotImplementedError("mesh-parallel training is not ported yet (ROADMAP.md)")
    cfg = config
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TrainConfig.device is cuda but CUDA is not available; "
                           "pass device='cpu' to train on the CPU")
    image_dtype = _dtype(cfg)

    class_weights = compute_class_weights(train_source.labels, num_classes)
    loss_fn = make_loss_fn(cfg.loss, class_weights, cfg.focal_gamma)
    state = build_state(model, cfg)
    train_step = make_train_step_weighted(
        cfg.loss, cfg.focal_gamma, augment=cfg.augment, image_dtype=image_dtype,
        recipe=cfg.augment_recipe,
    )
    cw_dev = torch.as_tensor(class_weights).to(device)
    eval_step = make_eval_step(image_dtype)

    early = EarlyStopping(
        patience=cfg.early_stopping_patience,
        delta=cfg.early_stopping_delta,
        metric_name=cfg.early_stopping_metric,
    )
    plateau = PlateauScheduler(
        lr=cfg.learning_rate, factor=cfg.plateau_factor, patience=cfg.plateau_patience
    )
    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": []}
    best_step = 0

    start_epoch = 0
    marker = os.path.join(resume_dir, "progress.json") if resume_dir else None
    if marker and os.path.exists(marker) and os.path.exists(os.path.join(resume_dir, "latest")):
        with open(marker) as f:
            prog = json.load(f)
        start_epoch = int(prog["epoch"]) + 1
        ckpt.restore_checkpoint(os.path.join(resume_dir, "latest"), state)
        best_dir = os.path.join(resume_dir, "best")
        if os.path.exists(best_dir):
            best = ckpt.load_checkpoint(best_dir, device)
            early.best_state, best_step = best["model"], best["step"]
        plateau.lr = prog.get("plateau_lr", plateau.lr)
        plateau.best = prog.get("plateau_best", plateau.best)
        plateau.num_bad = prog.get("plateau_num_bad", plateau.num_bad)
        early.best_score = prog.get("early_best_score", early.best_score)
        early.counter = prog.get("early_counter", early.counter)
        history["train_loss"] = list(prog.get("train_loss", []))
        history["val_loss"] = list(prog.get("val_loss", []))
        print(f"[resume] continuing from epoch {start_epoch}")

    t0 = time.time()
    epoch = start_epoch
    for epoch in range(start_epoch, cfg.num_epochs):
        batches = epoch_batches(
            train_source.labels, num_classes, cfg.batch_size,
            seed=cfg.seed, epoch=epoch, weighted=cfg.weighted_sampling,
        )
        # per-batch losses stay on the device: one host sync per epoch
        epoch_losses = []
        for bi, batch in enumerate(prefetch_batches(train_source, batches)):
            batch = _to_device(batch, device)
            loss = train_step(state, batch["image"], batch["metadata"], batch["label"],
                              cfg.seed, cw_dev)
            epoch_losses.append(loss)
            if tracker and cfg.log_every and (bi + 1) % cfg.log_every == 0:
                tracker.log_metric("batch_loss", float(loss), step=state.step)
        train_loss = float(torch.stack(epoch_losses).mean()) if epoch_losses else 0.0

        metrics, _, _, _, val_loss = evaluate(
            eval_step, state, val_source, cfg.batch_size, num_classes, loss_fn, device)
        metrics.update(epoch=epoch, train_loss=train_loss, val_loss=float(val_loss))
        history["train_loss"].append(train_loss)
        history["val_loss"].append(float(val_loss))

        set_learning_rate(state.optimizer, plateau.step(val_loss))
        if tracker:
            tracker.log_dict({k: v for k, v in metrics.items() if isinstance(v, (int, float))},
                             step=epoch + 1)

        improved = early(val_loss=val_loss, val_bacc=float(metrics["balanced_accuracy"]),
                         state=lambda: _snapshot(state.model))
        if improved:
            best_step = state.step
        if resume_dir:
            if improved:
                ckpt.save_checkpoint(os.path.join(resume_dir, "best"), state,
                                     model_state=early.best_state, step=best_step)
            ckpt.save_checkpoint(os.path.join(resume_dir, "latest"), state)
            with open(os.path.join(resume_dir, "progress.json"), "w") as f:
                json.dump({
                    "epoch": epoch,
                    "plateau_lr": plateau.lr,
                    "plateau_best": plateau.best,
                    "plateau_num_bad": plateau.num_bad,
                    "early_best_score": early.best_score,
                    "early_counter": early.counter,
                    "train_loss": history["train_loss"],
                    "val_loss": history["val_loss"],
                }, f)
        if early.early_stop:
            break

    if early.best_state is not None:
        # the returned state carries the best weights and the live optimizer
        state.model.load_state_dict(early.best_state)
        state.step = best_step
    final_metrics, labels, preds, probs, _ = evaluate(
        eval_step, state, val_source, cfg.batch_size, num_classes, loss_fn, device)
    final_metrics["fold"] = fold_num
    final_metrics["train process time"] = time.time() - t0
    final_metrics["epochs"] = epoch
    return state, final_metrics, {
        **history,
        "labels": labels,
        "predictions": preds,
        "probabilities": probs,
    }
