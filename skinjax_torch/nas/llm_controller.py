"""LLM-as-controller NAS (nas/optimization_train_process_pad_20_using_llm_as_
controller.py:303-337): history-conditioned prompt → local LLM → validated
config.

A copy of ``skinjax/nas/llm_controller.py`` without its unused pydantic
import. With no server to answer, a proposal falls back to a random config
from the search space.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from skinjax_torch.tools.llm_client import request_to_llm, safe_json_parse

def make_config_validator(search_space: Dict[str, Sequence]):
    """Validate an LLM-proposed config: right keys, in-space values."""

    def validate(config: Dict) -> Optional[Dict]:
        if not isinstance(config, dict):
            return None
        out = {}
        for k, choices in search_space.items():
            if k not in config:
                return None
            v = config[k]
            # tolerate stringified numbers/bools from the LLM
            for c in choices:
                if v == c or str(v) == str(c):
                    out[k] = c
                    break
            else:
                return None
        return out

    return validate


def build_prompt(
    search_space: Dict[str, Sequence],
    history: List[Tuple[Dict, float]],
    history_mode: str = "full",
    top_k: int = 10,
) -> str:
    """Search space + (config, reward) history → next-config prompt
    (HISTORY_MODE 'full' | 'top')."""
    if history_mode == "top":
        shown = sorted(history, key=lambda t: -t[1])[:top_k]
    else:
        shown = history
    lines = [
        "You are a neural architecture search controller for a multimodal",
        "skin-lesion classifier (CNN image tower + metadata MLP + fusion).",
        "Choose the next configuration to maximize validation balanced",
        "accuracy. Respond with ONLY a JSON object whose keys and values are",
        "exactly from this search space:",
        json.dumps({k: list(v) for k, v in search_space.items()}, default=str),
        "",
        "Evaluated so far (config -> balanced_accuracy):",
    ]
    for cfg, r in shown:
        lines.append(f"{json.dumps(cfg, default=str)} -> {r:.4f}")
    lines.append("")
    lines.append("Propose a NEW config (JSON only, no commentary):")
    return "\n".join(lines)


class LLMSearch:
    def __init__(
        self,
        search_space: Dict[str, Sequence],
        model_name: str,
        url: str = "http://localhost:11434/api/generate",
        history_mode: str = "full",
        max_retries: int = 3,
        seed: int = 0,
    ):
        self.space = {k: list(v) for k, v in search_space.items()}
        self.model_name = model_name
        self.url = url
        self.history_mode = history_mode
        self.max_retries = max_retries
        self.validate = make_config_validator(self.space)
        self.history: List[Tuple[Dict, float]] = []
        import numpy as np

        self._rng = np.random.default_rng(seed)

    def _random_config(self) -> Dict:
        return {k: v[int(self._rng.integers(len(v)))] for k, v in self.space.items()}

    def propose(self) -> Dict:
        """Ask the LLM; fall back to a random config after max_retries."""
        prompt = build_prompt(self.space, self.history, self.history_mode)
        for _ in range(self.max_retries):
            try:
                raw = request_to_llm(prompt, self.model_name, self.url)
            except Exception:
                break
            cfg = self.validate(safe_json_parse(raw) or {})
            if cfg is not None:
                return cfg
        return self._random_config()

    def observe(self, config: Dict, reward: float) -> None:
        self.history.append((config, float(reward)))

    @property
    def best(self) -> Tuple[Optional[Dict], float]:
        if not self.history:
            return None, -float("inf")
        cfg, r = max(self.history, key=lambda t: t[1])
        return cfg, r
