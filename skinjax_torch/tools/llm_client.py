"""Ollama HTTP client + response filtering (utils/request_to_llm.py:5-96):
the port's copy of ``skinjax/tools/llm_client.py``, on the standard
library's ``urllib`` (skinjax posts with ``requests``, which the card's
machine does not have).

Plain-HTTP ``POST /api/generate`` with JSON mode and think-mode handling for
qwen/gpt-oss-class models; ``filter_generated_response`` strips ``<think>``
blocks and extracts the first JSON object. A server that cannot be reached
raises ``urllib.error.URLError``.
"""

from __future__ import annotations

import json
import re
import urllib.request
from typing import Any, Dict, Optional

DEFAULT_URL = "http://localhost:11434/api/generate"
THINK_MODELS = ("qwen", "gpt-oss", "deepseek-r1")


def filter_generated_response(text: str) -> str:
    """Strip <think>…</think> and return the first JSON object found."""
    text = re.sub(r"<think>.*?</think>", "", text, flags=re.DOTALL)
    m = re.search(r"\{.*\}", text, flags=re.DOTALL)
    return m.group(0) if m else text.strip()


def safe_json_parse(text: str) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(filter_generated_response(text))
    except (json.JSONDecodeError, TypeError):
        return None


def request_to_llm(
    prompt: str,
    model_name: str,
    url: str = DEFAULT_URL,
    json_format: bool = True,
    timeout: float = 120.0,
) -> str:
    """One-shot completion from a local Ollama server."""
    payload: Dict[str, Any] = {
        "model": model_name,
        "prompt": prompt,
        "stream": False,
    }
    if json_format:
        payload["format"] = "json"
    if any(t in model_name.lower() for t in THINK_MODELS):
        payload["think"] = False
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()).get("response", "")
