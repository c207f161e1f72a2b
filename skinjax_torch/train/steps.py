"""Train and eval steps (counterpart of ``skinjax/train/steps.py``).

One train step: uint8 batch → on-device augmentation (K5 for the color stage
on the card) → forward under the model's autocast dtype → float32 loss →
backward → Adam. PyTorch runs it eagerly; skinjax's trace caches and buffer
donation have no counterpart here. The state (model, optimizer, step) lives
in ``TrainState`` and the steps update it in place.

Randomness: each step draws from generators seeded by (seed, step, stream),
the counterpart of ``jax.random.fold_in(rng, step)`` split into an augment
and a dropout key. Augmentation takes an explicit ``torch.Generator`` on the
batch's device. Dropout (``nn.Dropout`` in the fusion stage) draws from the
device's default generator, which the step reseeds inside
``torch.random.fork_rng``, so the caller's global RNG state is untouched and
a (seed, step) pair always gives the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from skinjax_torch.data.augment import augment_batch
from skinjax_torch.train.losses import weighted_loss

_AUGMENT, _DROPOUT = 0, 1


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm buffers), its optimizer and the
    number of train steps taken. The steps update it in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def step_seed(*words: int) -> int:
    """A 63-bit seed for a tuple of words, from numpy's SeedSequence: a train
    step's (seed, step, stream), or NAS's (seed, config key) and (seed, step,
    stream, config key)."""
    words = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def compute_dtype(model: nn.Module) -> torch.dtype:
    return getattr(model, "dtype", None) or torch.float32


def _inputs(model: nn.Module, image, metadata, image_dtype):
    """Round the image and the metadata to ``image_dtype`` (skinjax casts the
    metadata to the image dtype), then widen to the model's compute dtype, as
    JAX promotes bf16 inputs against fp32 parameters. Metadata is a (B, F)
    tensor or a dict of them (the token ids and mask of a sentence dataset,
    the categorical indices and numerics of a tabular one): float tensors
    are cast so, integer ones (ids, masks, indices) stay as they are."""
    dtype = compute_dtype(model)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(image_dtype).to(dtype) if t.is_floating_point() else t

    return image.to(dtype), cast(metadata)


def _train_step(state: TrainState, image_u8, metadata, seed: int, loss_of: Callable,
                augment: bool, image_dtype: torch.dtype, recipe: str) -> torch.Tensor:
    dev = image_u8.device
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, state.step, _AUGMENT))
    image = augment_batch(image_u8, gen, train=augment, out_dtype=image_dtype, recipe=recipe)
    image, metadata = _inputs(state.model, image, metadata, image_dtype)
    state.model.train()
    devices = [dev.index if dev.index is not None else torch.cuda.current_device()] \
        if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(step_seed(seed, state.step, _DROPOUT))
        loss = loss_of(state.model(image, metadata).float())
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    # jax.grad gives every parameter a gradient, zero where the loss does not
    # reach it (metablock's image_projector), and L2 decay still moves it
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_train_step_weighted(
    loss_name: str = "weighted_ce",
    focal_gamma: float = 2.0,
    augment: bool = True,
    image_dtype: torch.dtype = torch.bfloat16,
    recipe: str = "default",
) -> Callable:
    """Returns ``step(state, image_u8, metadata, label, seed, class_weights)
    -> loss``: a 0-dim float32 tensor on the device (the step does not wait
    for it). Inputs are tensors on the model's device; class weights are a
    call argument. Frozen parameters (``requires_grad=False``) are neither
    differentiated nor updated; BatchNorm statistics update in train mode."""
    wloss = weighted_loss(loss_name, focal_gamma)

    def step(state: TrainState, image_u8, metadata, label, seed: int, class_weights):
        return _train_step(state, image_u8, metadata, seed,
                           lambda logits: wloss(logits, label, class_weights),
                           augment, image_dtype, recipe)

    return step


def make_train_step(loss_fn: Callable, augment: bool = True,
                    image_dtype: torch.dtype = torch.bfloat16,
                    recipe: str = "default") -> Callable:
    """Returns ``step(state, image_u8, metadata, label, seed) -> loss`` with
    the loss (and any class weights) bound in ``loss_fn(logits, labels)``."""

    def step(state: TrainState, image_u8, metadata, label, seed: int):
        return _train_step(state, image_u8, metadata, seed, lambda logits: loss_fn(logits, label),
                           augment, image_dtype, recipe)

    return step


def make_eval_step(image_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns ``step(state, image_u8, metadata) -> logits`` (float32): eval
    normalize in the image dtype, then the model in eval mode."""

    @torch.no_grad()
    def step(state: TrainState, image_u8, metadata):
        image = augment_batch(image_u8, train=False, out_dtype=image_dtype)
        image, metadata = _inputs(state.model, image, metadata, image_dtype)
        state.model.eval()
        return state.model(image, metadata).float()

    return step


def make_loss_eval_step(loss_fn: Callable,
                        image_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns ``step(state, image_u8, metadata, label) -> (loss, logits)``."""
    eval_step = make_eval_step(image_dtype)

    def step(state: TrainState, image_u8, metadata, label):
        logits = eval_step(state, image_u8, metadata)
        return loss_fn(logits, label), logits

    return step
