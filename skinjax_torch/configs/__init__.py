"""The typed experiment configuration with ``.env``-compatible knob names
(a copy of ``skinjax/configs/__init__.py`` over the port's ``TrainConfig``).

``load_env_config`` reads the reference's ``conf/.env`` knobs (NUM_EPOCHS,
BATCH_SIZE, UNFREEZE_WEIGHTS, LIST_NUM_HEADS, COMMON_DIM, K_FOLDS, …) from a
file and the process environment, with the same names and the same literal
parser as skinjax; ``save_config`` / ``load_config`` write and read it as
JSON. The port's ``TrainConfig`` adds ``device`` (``cuda`` by default), and
``load_env_config`` also reads the sentence datasets' ``TEXT_MODEL_NAME``,
``MAX_SEQ_LENGTH`` and ``TOKENIZERS_DIR``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from skinjax_torch.train.loop import TrainConfig


@dataclasses.dataclass
class ExperimentConfig:
    # sweep axes
    attention_mechanisms: List[str] = dataclasses.field(default_factory=lambda: ["concatenation"])
    cnn_model_names: List[str] = dataclasses.field(default_factory=lambda: ["resnet-50"])
    list_num_heads: List[int] = dataclasses.field(default_factory=lambda: [8])
    text_model_name: str = "one-hot-encoder"
    model_name: str = "multimodal"

    # data
    dataset: str = "pad-ufes-20"
    dataset_folder_name: str = "PAD-UFES-20"
    dataset_folder_path: Optional[str] = None
    metadata_csv: Optional[str] = None
    images_dir: Optional[str] = None
    results_folder_path: str = "./results"

    # model dims
    common_dim: int = 512
    k_folds: int = 5
    # sentence datasets: tokenizer length and artifacts dir (None =
    # $SKINJAX_TOKENIZERS, then ./tokenizers)
    max_seq_length: int = 256
    tokenizers_dir: Optional[str] = None

    # training
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    # NAS (not ported yet; kept so that configs read and write the same JSON)
    search_steps: int = 500
    history_mode: str = "full"
    llm_model_name_sequence_generator: Optional[str] = None
    save_to_disk: bool = True


def _parse_literal(s: str, default: Any) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return default


def _parse_env_file(path: str) -> Dict[str, str]:
    env: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            env[k.strip()] = v.strip().strip('"').strip("'")
    return env


def load_env_config(
    env_path: Optional[str] = None, overrides: Optional[Dict[str, str]] = None
) -> ExperimentConfig:
    """An ExperimentConfig from a reference-style .env file plus the process
    environment (the process environment wins, then ``overrides``)."""
    env: Dict[str, str] = {}
    if env_path and os.path.exists(env_path):
        env.update(_parse_env_file(env_path))
    env.update(os.environ)
    if overrides:
        env.update(overrides)

    get = lambda k, d=None: env.get(k, d)  # noqa: E731
    unfreeze = str(get("UNFREEZE_WEIGHTS", "unfrozen_weights")).lower()
    # the reference stores booleans here historically; normalize
    if unfreeze in ("true", "1"):
        unfreeze = "unfrozen_weights"
    if unfreeze in ("false", "0"):
        unfreeze = "frozen_weights"

    train = TrainConfig(
        num_epochs=int(get("NUM_EPOCHS", 10)),
        batch_size=int(get("BATCH_SIZE", 32)),
        unfreeze_weights=unfreeze,
    )
    return ExperimentConfig(
        text_model_name=str(get("TEXT_MODEL_NAME", "one-hot-encoder")),
        max_seq_length=int(get("MAX_SEQ_LENGTH", 256)),
        tokenizers_dir=get("TOKENIZERS_DIR"),
        list_num_heads=list(_parse_literal(str(get("LIST_NUM_HEADS", "[8]")), [8])),
        common_dim=int(get("COMMON_DIM", 512)),
        k_folds=int(get("K_FOLDS", 5)),
        dataset_folder_name=str(get("DATASET_FOLDER_NAME", "PAD-UFES-20")),
        dataset_folder_path=get("DATASET_FOLDER_PATH"),
        results_folder_path=str(get("RESULTS_FOLDER_PATH", "./results")),
        search_steps=int(get("SEARCH_STEPS", 500)),
        history_mode=str(get("HISTORY_MODE", "full")),
        llm_model_name_sequence_generator=get("LLM_MODEL_NAME_SEQUENCE_GENERATOR"),
        save_to_disk=str(get("save_to_disk", "True")).lower() in ("true", "1"),
        train=train,
    )


def save_config(cfg: ExperimentConfig, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        d = json.load(f)
    train = TrainConfig(**d.pop("train"))
    return ExperimentConfig(train=train, **d)
