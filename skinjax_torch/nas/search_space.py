"""NAS search space (nas/optimization_train_process_pad_20.py:462-474): a copy of
``skinjax/nas/search_space.py`` (importing ``skinjax.nas`` imports JAX)."""

from __future__ import annotations

from typing import Dict, List, Sequence

DEFAULT_SEARCH_SPACE: Dict[str, List] = {
    "num_blocks": [2, 5, 10],
    "initial_filters": [16, 32, 64],
    "kernel_size": [3, 5],
    "layers_per_block": [1, 2],
    "use_pooling": [True, False],
    "common_dim": [64, 128, 256, 512],
    "attention_mecanism": ["concatenation", "crossattention", "metablock", "gfcam"],
    "num_layers_text_fc": [1, 2, 3],
    "neurons_per_layer_size_of_text_fc": [64, 128, 256, 512],
    "num_layers_fc_module": [1, 2],
    "neurons_per_layer_size_of_fc_module": [256, 512],
}


def filters_from_config(config: Dict, cap: int = 512) -> List[int]:
    """num_blocks + initial_filters -> doubling filter schedule, capped."""
    if "filters" in config:
        return list(config["filters"])
    n = int(config.get("num_blocks", 3))
    f0 = int(config.get("initial_filters", 64))
    return [min(f0 * (2**i), cap) for i in range(n)]


def config_to_indices(config: Dict, space: Dict[str, Sequence]) -> Dict[str, int]:
    return {k: list(space[k]).index(config[k]) for k in space if k in config}


def indices_to_config(indices: Dict[str, int], space: Dict[str, Sequence]) -> Dict:
    return {k: space[k][int(i)] for k, i in indices.items()}
