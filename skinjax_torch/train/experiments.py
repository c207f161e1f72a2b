"""Top-level experiment sweeps (counterpart of ``skinjax/train/experiments.py``):
the reference's per-dataset ``train_*.py`` entry points behind one command,
with per-dataset loss and splitter presets.

Every (mechanism × backbone × num_heads) cell runs the full k-fold, each
fold on a new model with weights drawn from ``TrainConfig.seed``. A cell
that fails is logged and the sweep goes on, as in the reference; so a caller
that checks a run counts the fold metrics it gets back (mechanisms ×
backbones × heads × folds).
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from typing import Dict, List, Optional

import torch

from skinjax_torch.configs import ExperimentConfig
from skinjax_torch.data.pipeline import FileSource, ImageStore, TokenSource
from skinjax_torch.data.schemas import PreparedDataset, prepare_dataset
from skinjax_torch.data.tokenize import load_tokenizer, tokenize_sentences
from skinjax_torch.models.factory import create_model
from skinjax_torch.models.text.sentence import is_sentence_model
from skinjax_torch.train.kfold import run_kfold

DATASET_PRESETS: Dict[str, Dict] = {
    "pad-ufes-20": {"loss": "weighted_ce", "grouped": True},
    "pad-ufes-25": {"loss": "weighted_ce", "grouped": True},
    "isic-2019": {"loss": "weighted_ce", "grouped": True},
    "isic-2020": {"loss": "weighted_ce", "grouped": False},
    "derm7pt": {"loss": "focal", "grouped": True},
    "midas": {"loss": "focal", "grouped": True},
    "milk10k": {"loss": "focal", "grouped": True},
    "skindisnet": {"loss": "weighted_ce", "grouped": False},
}


def build_source(prepared: PreparedDataset, images_dir: str, image_size=(224, 224),
                 cache: bool = True) -> FileSource:
    store = ImageStore(images_dir, size=image_size, cache=cache)
    return FileSource(store, prepared.image_files, prepared.features, prepared.labels)


def build_token_source(prepared: PreparedDataset, images_dir: str, text_model_name: str,
                       max_seq_length: int = 256, tokenizers_dir: Optional[str] = None,
                       image_size=(224, 224), cache: bool = True) -> TokenSource:
    """The sentence datasets' source: the ``sentence`` column of the metadata
    CSV (LLM-generated sentences) tokenized with the tokenizer of
    ``text_model_name`` (``load_tokenizer``, from ``tokenizers_dir/<name>``,
    or ``$SKINJAX_TOKENIZERS/<name>`` when None) at ``max_seq_length``; the
    metadata of a batch is ``{"input_ids", "attention_mask"}``."""
    if prepared.raw is None or "sentence" not in prepared.raw:
        raise ValueError(
            f"text model {text_model_name!r} needs a 'sentence' column in the metadata CSV "
            "(LLM-generated sentences)")
    tok = load_tokenizer(
        text_model_name,
        os.path.join(tokenizers_dir, text_model_name) if tokenizers_dir else None)
    enc = tokenize_sentences([str(x) for x in prepared.raw["sentence"]], tok,
                             max_length=max_seq_length)
    store = ImageStore(images_dir, size=image_size, cache=cache)
    return TokenSource(store, prepared.image_files, enc["input_ids"], enc["attention_mask"],
                       prepared.labels)


def run_experiments(
    cfg: ExperimentConfig,
    source=None,
    prepared: Optional[PreparedDataset] = None,
    tracker=None,
) -> List[Dict]:
    """The mechanism × backbone × heads sweep. Returns all fold metrics."""
    preset = DATASET_PRESETS.get(cfg.dataset, {"loss": "weighted_ce", "grouped": True})

    if prepared is None:
        metadata_csv = cfg.metadata_csv or os.path.join(cfg.dataset_folder_path or ".",
                                                        "metadata.csv")
        prepared = prepare_dataset(
            cfg.dataset, metadata_csv,
            featurizer_path=os.path.join(cfg.results_folder_path, "preprocess_data",
                                         f"featurizer_{cfg.dataset}.json"),
        )
    if source is None:
        images_dir = cfg.images_dir or os.path.join(cfg.dataset_folder_path or ".", "images")
        if is_sentence_model(cfg.text_model_name):
            source = build_token_source(prepared, images_dir, cfg.text_model_name,
                                        max_seq_length=cfg.max_seq_length,
                                        tokenizers_dir=cfg.tokenizers_dir)
        else:
            source = build_source(prepared, images_dir)

    train_cfg = cfg.train
    # the model computes in the image dtype (bf16 autocast by default), as
    # the flagship trains and serves; skinjax's sweep leaves its model fp32
    model_dtype = torch.bfloat16 if train_cfg.image_dtype == "bfloat16" else None
    if train_cfg.loss == "weighted_ce" and preset["loss"] != "weighted_ce":
        train_cfg = dataclasses.replace(train_cfg, loss=preset["loss"])
    if is_sentence_model(cfg.text_model_name) and train_cfg.augment_recipe == "default":
        # sentence datasets get the reference's heavier augmentation
        train_cfg = dataclasses.replace(train_cfg, augment_recipe="sentence")

    all_metrics: List[Dict] = []
    for mechanism in cfg.attention_mechanisms:
        for backbone in cfg.cnn_model_names:
            for num_heads in cfg.list_num_heads:
                name = f"{cfg.model_name}_{backbone}_{mechanism}_h{num_heads}"
                try:
                    metrics = run_kfold(
                        model_factory=lambda: create_model(  # noqa: B023
                            num_classes=prepared.num_classes,
                            model_name=cfg.model_name,
                            cnn_model_name=backbone,  # noqa: B023
                            text_model_name=cfg.text_model_name,
                            attention_mechanism=mechanism,  # noqa: B023
                            num_heads=num_heads,  # noqa: B023
                            common_dim=cfg.common_dim,
                            vocab_size=prepared.feature_dim,
                            dtype=model_dtype,
                            seed=train_cfg.seed,
                        ),
                        source=source,
                        labels=prepared.labels,
                        groups=prepared.groups if preset["grouped"] else None,
                        num_classes=prepared.num_classes,
                        class_names=prepared.class_names,
                        config=train_cfg,
                        k_folds=cfg.k_folds,
                        results_dir=os.path.join(cfg.results_folder_path, name),
                        model_name=name,
                        tracker=tracker,
                        save_checkpoints=cfg.save_to_disk,
                    )
                    for m in metrics:
                        m.update(mechanism=mechanism, backbone=backbone, num_heads=num_heads,
                                 model=name)
                    all_metrics.extend(metrics)
                except Exception:
                    # the sweep survives a failed cell (train_pad_20.py:486-488)
                    print(f"[experiments] cell {name} failed:")
                    traceback.print_exc()
    return all_metrics
