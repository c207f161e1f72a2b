"""Population training: K NAS candidates a step (counterpart of
``skinjax/nas/population.py``).

The reference NAS loop trains one candidate per controller step
(nas/optimization_train_process_pad_20.py:308-337). Here candidates are
bucketed by shape-envelope keys, and each bucket trains as one
``SuperNet`` (``nas/supernet.py``): ``torch.func.vmap`` over
``torch.func.functional_call`` on the candidates' stacked parameters and
masks, so the augmented batch is computed once a step (K5 on the card) and
shared, and the card sees K candidates' work in each launch. No parameter is
shared between candidates, so one backward of the sum of the K weighted
losses gives each candidate its own gradient, and one
``torch.optim.Adam(weight_decay=wd)`` over the stacked tensors updates each
candidate as its own would (Adam with L2 decay is elementwise): skinjax's
``add_decayed_weights → adam`` per candidate.

Randomness is keyed by the config, never by a candidate's place in its
bucket: ``exact_init`` draws each candidate's own ``DynamicCNN`` from
(seed, config key) and embeds it; the dropout keep masks are drawn on the
host at the candidate's own width, one generator a candidate seeded from
(seed, step, dropout stream, config key), and passed in as data. So with
``exact_init`` (the evaluator's default) a config re-sampled later earns the
same reward whatever its bucket-mates and envelope (skinjax's dropout masks
follow the envelope's width), the premise of ``run_nas``'s memoization, and
a step draws the same masks on the card and on the CPU.

Reward semantics against the sequential path: every candidate runs the full
``num_epochs`` (the bucket stops early only when *all* candidates have
exhausted their patience) and the reward is the best per-candidate
validation balanced accuracy over the epochs.

Left out, each existing only for XLA's compile economics (eager PyTorch has
no programs to reuse): the fixed envelopes, ``pad_width``, the program
cache, ``SKINJAX_POP_HBM_GB`` (the width cap's budget is what the device's
allocator could hand out, reckoned per candidate by the port's own
``population_step_bytes``; skinjax's ``envelope_step_bytes`` is kept for
comparison) and ``SKINJAX_POP_CLEAR_ON_FAIL`` (a failed bucket's tensors
are always freed, the card's cache emptied, before its candidates are
retried one by one).
"""

from __future__ import annotations

import gc
import json
import os
import zlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, vmap

from skinjax_torch.data.augment import augment_batch
from skinjax_torch.data.pipeline import prefetch_batches
from skinjax_torch.data.sampling import compute_class_weights, epoch_batches
from skinjax_torch.nas.dynamic_model import lecun_init, make_dynamic_model
from skinjax_torch.nas.search_space import filters_from_config
from skinjax_torch.nas.supernet import (
    DROPOUT_RATE,
    FEAT_PAD,
    SuperNet,
    candidate_masks,
    dropout_sites,
    embed_params,
    envelope_of,
)
from skinjax_torch.train.loop import TrainConfig, _to_device
from skinjax_torch.train.losses import weighted_loss
from skinjax_torch.train.metrics import classification_metrics
from skinjax_torch.train.steps import _AUGMENT, _DROPOUT, step_seed

DEFAULT_BUCKET_KEYS = ("use_pooling", "num_blocks", "kernel_size")

# DynamicCNN's cfg.get(...) defaults (nas/dynamic_model.py) — population
# configs normalize through these so partially-specified configs (valid for
# the sequential path) bucket/envelope instead of KeyError-ing
_CONFIG_DEFAULTS = {
    "num_blocks": 3,
    "initial_filters": 64,
    "kernel_size": 3,
    "layers_per_block": 2,
    "use_pooling": True,
    "common_dim": 512,
    "attention_mecanism": "concatenation",
    "num_layers_text_fc": 2,
    "neurons_per_layer_size_of_text_fc": 512,
    "num_layers_fc_module": 2,
    "neurons_per_layer_size_of_fc_module": 512,
}

# Of the memory the device's allocator could hand out, the share a bucket may
# plan on with population_step_bytes' reckoning; the rest is left to
# fragmentation of the caching allocator
MEMORY_SHARE = 0.9
# Maps of the largest conv layer that a step holds at once beyond what autograd
# saves (the backward of a masked GroupNorm and its conv, with the vmapped
# layout's copies and the convolution's workspace)
TRANSIENT_MAPS = 7


def _normalize(config: Dict) -> Dict:
    return {**_CONFIG_DEFAULTS, **dict(config)}


def _config_key(config: Dict) -> int:
    """Stable per-config seed offset (skinjax's, the same crc32 of the same
    JSON): the same config draws the same init and dropout regardless of
    which group/bucket it was sampled into."""
    return zlib.crc32(
        json.dumps(
            {k: str(v) for k, v in sorted(config.items())}
        ).encode()
    )


def _bucket(configs: Sequence[Dict], keys: Sequence[str]):
    buckets = defaultdict(list)
    for i, c in enumerate(configs):
        buckets[tuple(dict(c)[k] for k in keys)].append(i)
    return list(buckets.values())


def envelope_step_bytes(env, image_hw, batch_size: int) -> int:
    """Rough per-candidate device footprint (bytes) of one supernet train
    step (skinjax's estimate, kept as it is): one float32 map of H·W·C per
    conv layer, spatial halving per block under pooling, ×1.25 for the
    GroupNorm/backward residue."""
    H, W = int(image_hw[0]), int(image_hw[1])
    f = filters_from_config(
        {"num_blocks": env.num_blocks, "initial_filters": env.initial_filters}
    )
    n_layers = 2 if env.layers_per_block >= 2 else 1
    total = 0
    for bi in range(env.num_blocks):
        total += n_layers * H * W * f[bi] * 4
        if env.use_pooling and min(H, W) >= 2:
            H, W = max(H // 2, 1), max(W // 2, 1)
    return int(total * 1.25) * int(batch_size)


def population_step_bytes(env, image_hw, batch_size: int, vocab_size: int = 85,
                          num_classes: int = 6) -> int:
    """The port's device footprint (bytes) of one candidate's train step in a
    population of ``env``: its parameters, their gradient and Adam's two
    moments; the float32 maps autograd saves of each block at the batch
    (each conv layer's centred map and ReLU
    output; the block's output once more, the bypass sum or the pool's
    copy, where it has either; a pooled block's int64 indices and its pooled
    map's copy for the next conv, a quarter map each; its global average at
    ``FEAT_PAD``); the float image; and ``TRANSIENT_MAPS`` maps of the
    largest layer."""
    H, W = int(image_hw[0]), int(image_hw[1])
    f = filters_from_config(
        {"num_blocks": env.num_blocks, "initial_filters": env.initial_filters}
    )
    layers = 2 if env.layers_per_block >= 2 else 1
    maps, largest = 3 * H * W + env.num_blocks * FEAT_PAD, 0
    for c in f:
        m = H * W * c
        largest = max(largest, m)
        pooled = env.use_pooling and min(H, W) >= 2
        maps += (2 * layers + (layers == 2 or pooled)) * m
        if pooled:
            H, W = max(H // 2, 1), max(W // 2, 1)
            maps += 3 * H * W * c  # the indices (8 bytes) and the copy
    with torch.device("meta"):
        params = sum(p.numel() for p in SuperNet(env, num_classes=num_classes,
                                                 vocab_size=vocab_size).parameters())
    return 4 * (int(batch_size) * (maps + TRANSIENT_MAPS * largest) + 4 * params)


def device_budget(device: torch.device) -> int:
    """Bytes a bucket's step may plan on: ``MEMORY_SHARE`` of what the
    device's allocator could hand out (the card's free memory and what
    PyTorch's caching allocator holds unused: a bucket trained before leaves
    its blocks there), or of the host's available memory on the CPU."""
    if device.type == "cuda":
        free = (torch.cuda.mem_get_info(device)[0] + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
    else:
        free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    return int(free * MEMORY_SHARE)


def hbm_width_cap(env, image_hw, batch_size: int, budget: int, vocab_size: int = 85,
                  num_classes: int = 6) -> int:
    """Max vmap width for this envelope within ``budget`` bytes."""
    per = population_step_bytes(env, image_hw, batch_size, vocab_size, num_classes)
    return max(1, int(budget // max(per, 1)))


class Population:
    """The candidates of one envelope, trained together: stacked parameters
    (each tensor (K, …)) and masks on the device, one Adam over them, and a
    vmapped train step and eval forward."""

    def __init__(self, configs: Sequence[Dict], num_classes: int, vocab_size: int,
                 cfg: TrainConfig, class_weights: np.ndarray, seed: int = 42,
                 exact_init: bool = False):
        self.configs = [dict(c) for c in configs]
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.env = env = envelope_of(self.configs)
        with torch.device("meta"):  # a skeleton: functional_call supplies every tensor
            self.model = SuperNet(env, num_classes=num_classes, vocab_size=vocab_size)
        self.keys = [_config_key(c) for c in self.configs]

        def supernet(s):
            with torch.device("meta"):
                sup = SuperNet(env, num_classes=num_classes, vocab_size=vocab_size)
            return lecun_init(sup.to_empty(device="cpu"), s).state_dict()

        if exact_init:
            # each candidate starts from the init its own DynamicCNN draws
            # (keyed by config), embedded into one supernet draw
            sup0 = supernet(step_seed(seed))
            states = [embed_params(make_dynamic_model(c, num_classes, vocab_size,
                                                      seed=step_seed(seed, k)).state_dict(),
                                   sup0, c, env)
                      for c, k in zip(self.configs, self.keys)]
        else:
            states = [supernet(step_seed(seed, k)) for k in self.keys]
        self.params = {n: torch.stack([s[n] for s in states]).to(self.device).requires_grad_()
                       for n in states[0]}
        del states
        masks = [candidate_masks(c, env) for c in self.configs]
        self.masks = {n: torch.stack([torch.as_tensor(m[n]) for m in masks]).to(self.device)
                      for n in masks[0]}
        self.optimizer = torch.optim.Adam(list(self.params.values()), lr=cfg.learning_rate,
                                          weight_decay=cfg.weight_decay)
        self.loss = weighted_loss(cfg.loss, cfg.focal_gamma)
        self.class_weights = torch.as_tensor(class_weights, dtype=torch.float32).to(self.device)
        self.image_dtype = torch.bfloat16 if cfg.image_dtype == "bfloat16" else torch.float32
        self.step = 0

    def _apply(self, params, masks, image, metadata, keep=None):
        return functional_call(self.model, params, (image, metadata, masks), {"keep": keep})

    def dropout_keep(self, batch: int) -> Dict[str, torch.Tensor]:
        """This step's keep masks, (K, batch, fc_width) a dropout site. Each
        candidate's are drawn on the host at its own width from (seed, step,
        dropout, config key) and padded with True (the columns past it are
        masked): they depend on neither the bucket nor the device."""
        sites = dropout_sites(self.env)
        per = []
        for c, k in zip(self.configs, self.keys):
            g = torch.Generator().manual_seed(step_seed(self.cfg.seed, self.step, _DROPOUT, k))
            width = int(c["neurons_per_layer_size_of_fc_module"])
            per.append([F.pad(torch.rand(batch, width, generator=g) < 1.0 - DROPOUT_RATE,
                              (0, self.env.fc_width - width), value=True)
                        for _ in sites])
        return {site: torch.stack([p[i] for p in per]).to(self.device)
                for i, site in enumerate(sites)}

    def train_step(self, image_u8, metadata, label) -> torch.Tensor:
        """One step of every candidate on one batch (tensors on the device):
        the batch augmented once, then forward, the K weighted losses,
        backward and Adam. Returns the K losses (float32, on the device)."""
        gen = torch.Generator(device=image_u8.device).manual_seed(
            step_seed(self.cfg.seed, self.step, _AUGMENT))
        image = augment_batch(image_u8, gen, train=self.cfg.augment, out_dtype=self.image_dtype,
                              recipe=self.cfg.augment_recipe)
        keep = self.dropout_keep(image.shape[0])
        logits = vmap(self._apply, in_dims=(0, 0, None, None, 0))(
            self.params, self.masks, image, metadata, keep)
        losses = torch.stack([self.loss(lg.float(), label, self.class_weights) for lg in logits])
        self.optimizer.zero_grad(set_to_none=True)
        losses.sum().backward()  # the supernet reads every parameter it has
        self.optimizer.step()
        self.step += 1
        return losses.detach()

    @torch.no_grad()
    def logits(self, image_u8, metadata) -> torch.Tensor:
        """(K, B, num_classes) float32 eval logits of every candidate."""
        image = augment_batch(image_u8, train=False, out_dtype=self.image_dtype)
        return vmap(self._apply, in_dims=(0, 0, None, None))(
            self.params, self.masks, image, metadata).float()


class PopulationTrainer:
    """Trains a list of candidate configs with vmapped supernet steps.

    ``evaluate(configs)`` returns one reward (best val balanced accuracy)
    per config, in order. It trains on ``config.device`` (``cuda`` unless the
    caller asks for the CPU)."""

    def __init__(
        self,
        train_source,
        val_source,
        num_classes: int,
        config: Optional[TrainConfig] = None,
        bucket_keys: Sequence[str] = DEFAULT_BUCKET_KEYS,
        exact_init: bool = False,
        seed: int = 42,
        vocab_size: Optional[int] = None,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("mesh-parallel population training is not ported yet "
                                      "(ROADMAP.md)")
        self.train_source = train_source
        self.val_source = val_source
        self.num_classes = num_classes
        self.cfg = config or TrainConfig(
            num_epochs=10, early_stopping_patience=5,
            early_stopping_metric="val_bacc",
        )
        self.device = torch.device(self.cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainConfig.device is cuda but CUDA is not available; "
                               "pass device='cpu' to train on the CPU")
        self.bucket_keys = tuple(bucket_keys)
        self.exact_init = exact_init
        self.seed = seed
        if vocab_size is None:
            vocab_size = int(
                train_source.batch(np.arange(1))["metadata"].shape[1]
            )
        self.vocab_size = vocab_size
        self.class_weights = compute_class_weights(
            train_source.labels, num_classes
        )

    def _train_bucket(self, configs: List[Dict]) -> List[float]:
        cfg = self.cfg
        K = len(configs)
        env = envelope_of(configs)
        # a wide envelope (e.g. no pooling × max filters) can need more
        # device memory than the card has: train an oversized bucket in
        # chunks of the width that fits
        image_hw = self.train_source.batch(np.arange(1))["image"].shape[1:3]
        cap = hbm_width_cap(env, image_hw, cfg.batch_size, device_budget(self.device),
                            self.vocab_size, self.num_classes)
        if K > cap:
            per = population_step_bytes(env, image_hw, cfg.batch_size, self.vocab_size,
                                        self.num_classes)
            print(f"[nas] bucket of {K} capped to vmap width {cap} "
                  f"(envelope needs ~{per / 1e9:.1f} GB/candidate)")
            out: List[float] = []
            for i in range(0, K, cap):
                out.extend(self._train_bucket(configs[i:i + cap]))
            return out
        pop = Population(configs, self.num_classes, self.vocab_size, cfg, self.class_weights,
                         seed=self.seed, exact_init=self.exact_init)

        best = np.full(K, -np.inf)
        since_improve = np.zeros(K, np.int32)
        n_val = len(self.val_source)
        labels = self.val_source.labels[:n_val]
        for epoch in range(cfg.num_epochs):
            batches = epoch_batches(
                self.train_source.labels, self.num_classes, cfg.batch_size,
                seed=cfg.seed, epoch=epoch, weighted=cfg.weighted_sampling,
            )
            for batch in prefetch_batches(self.train_source, batches):
                batch = _to_device(batch, self.device)
                pop.train_step(batch["image"], batch["metadata"], batch["label"])
            # full val pass, all K candidates at once
            probs = np.zeros((K, n_val, self.num_classes), np.float32)
            for start in range(0, n_val, cfg.batch_size):
                idx = np.arange(start, min(start + cfg.batch_size, n_val))
                vb = _to_device(self.val_source.batch(idx), self.device)
                logits = pop.logits(vb["image"], vb["metadata"])
                probs[:, idx] = torch.softmax(logits, dim=-1).cpu().numpy()
            improved = False
            for ki in range(K):
                m = classification_metrics(
                    labels, probs[ki].argmax(-1), probs[ki], self.num_classes
                )
                bacc = float(m["balanced_accuracy"])
                if bacc > best[ki] + 1e-12:
                    best[ki] = bacc
                    since_improve[ki] = 0
                    improved = True
                else:
                    since_improve[ki] += 1
            if not improved and (
                since_improve >= cfg.early_stopping_patience
            ).all():
                break
        return [float(b) for b in best]

    def _free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def evaluate(self, configs: Sequence[Dict]) -> List[Optional[float]]:
        """Rewards per config, in order. A config that fails to train gets
        ``None`` (run_nas scores it 0.0 for the controller — reference
        parity — but skips memoizing it, so a transient failure doesn't pin
        a config at zero for the rest of the search)."""
        configs = [_normalize(c) for c in configs]
        rewards: List[Optional[float]] = [None] * len(configs)
        for idx_group in _bucket(configs, self.bucket_keys):
            group = [configs[i] for i in idx_group]
            group_rewards: Optional[List[Optional[float]]] = None
            try:
                group_rewards = self._train_bucket(group)
            except Exception as e:
                print(f"[nas] population bucket failed "
                      f"({type(e).__name__}: {e})")
            if group_rewards is None:
                # out of the except clause, the failed bucket's tensors are
                # no longer held by the traceback: free them before retrying
                self._free()
                if len(group) == 1:
                    group_rewards = [None]
                else:
                    # isolate the failure: retry each candidate alone so one
                    # pathological config can't zero its bucket-mates
                    group_rewards = []
                    for c in group:
                        try:
                            group_rewards.extend(self._train_bucket([c]))
                        except Exception as e2:
                            print(f"[nas] candidate failed alone "
                                  f"({type(e2).__name__}: {e2})")
                            group_rewards.append(None)
                            self._free()
            for i, r in zip(idx_group, group_rewards):
                rewards[i] = r
        return rewards


def make_population_evaluator(
    source,
    num_classes: int,
    train_cfg: Optional[TrainConfig] = None,
    seed: int = 42,
    # exact_init by default: each candidate starts from the init its
    # standalone DynamicCNN would draw (keyed by config, independent of
    # grouping/envelope), so a re-sampled config re-earns the same reward
    # at the same envelope — the property run_nas's memoization and
    # REINFORCE comparisons rely on
    exact_init: bool = True,
    bucket_keys: Sequence[str] = DEFAULT_BUCKET_KEYS,
    mesh=None,
) -> Callable[[Sequence[Dict]], List[Optional[float]]]:
    """80/20 split (as nas/optimization_train_process_pad_20.py:232-237) +
    a PopulationTrainer over it; returns ``configs -> rewards``."""
    from skinjax_torch.data.splits import train_val_split
    from skinjax_torch.train.kfold import SubsetSource

    labels = source.labels
    train_idx, val_idx = train_val_split(labels, val_fraction=0.2, seed=seed)
    trainer = PopulationTrainer(
        SubsetSource(source, train_idx),
        SubsetSource(source, val_idx),
        num_classes,
        config=train_cfg,
        bucket_keys=bucket_keys,
        exact_init=exact_init,
        seed=seed,
        vocab_size=int(source.features.shape[1]),
        mesh=mesh,
    )
    return trainer.evaluate
