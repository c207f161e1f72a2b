"""A file-based experiment tracker with MLflow's call surface (a copy of
``skinjax/tracking/__init__.py``, which the port cannot import without JAX).

``set_experiment`` / ``start_run`` / ``log_param`` / ``log_metric`` /
``log_dict`` write the same files as skinjax's tracker: per run
``<root>/<experiment>/<run_name>-<id>/run.json``, ``params.json`` and an
append-only ``metrics.jsonl``. skinjax's optional pass-through of
``set_experiment`` to an installed ``mlflow`` is left out.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, root: str = "./results/tracking"):
        self.root = root
        self.experiment = "default"
        self._run_dir: Optional[str] = None
        self._metrics_f = None

    def set_experiment(self, name: str) -> None:
        self.experiment = name

    @contextmanager
    def start_run(self, run_name: str):
        run_id = f"{run_name}-{uuid.uuid4().hex[:8]}"
        self._run_dir = os.path.join(self.root, self.experiment, run_id)
        os.makedirs(self._run_dir, exist_ok=True)
        meta = {"run_name": run_name, "run_id": run_id, "start_time": time.time()}
        with open(os.path.join(self._run_dir, "run.json"), "w") as f:
            json.dump(meta, f)
        self._metrics_f = open(os.path.join(self._run_dir, "metrics.jsonl"), "a")
        try:
            yield self
        finally:
            self._metrics_f.close()
            self._metrics_f = None
            meta["end_time"] = time.time()
            with open(os.path.join(self._run_dir, "run.json"), "w") as f:
                json.dump(meta, f)
            self._run_dir = None

    def _params_path(self) -> str:
        return os.path.join(self._run_dir or self.root, "params.json")

    def log_param(self, key: str, value: Any) -> None:
        path = self._params_path()
        params: Dict[str, Any] = {}
        if os.path.exists(path):
            with open(path) as f:
                params = json.load(f)
        params[key] = value
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(params, f, indent=1)

    def log_metric(self, key: str, value: float, step: Optional[int] = None) -> None:
        rec = {"key": key, "value": float(value), "step": step, "t": time.time()}
        if self._metrics_f is not None:
            self._metrics_f.write(json.dumps(rec) + "\n")
            self._metrics_f.flush()

    def log_dict(self, d: Dict[str, Any], step: Optional[int] = None) -> None:
        for k, v in d.items():
            if isinstance(v, (int, float)):
                self.log_metric(k, v, step)
            else:
                self.log_param(k, v)
