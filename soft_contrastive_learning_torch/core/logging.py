"""Run logging and metrics, own copy of
``soft_contrastive_learning_tpu/core/logging.py`` (``RunLogger``,
``MetricsWriter``): a text log teed to stdout, and JSONL scalar records
``{"step": int, "tag": str, "value": float, "t": unix}``, one file per
writer role (``metrics_local.jsonl``, ...)."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional


class RunLogger:
    """Append-only text log teeing to stdout; thread-safe."""

    def __init__(self, out_dir: Optional[str] = None, filename: str = "train_log.txt"):
        self._lock = threading.Lock()
        self._fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, filename), "a")

    def log(self, msg: Any) -> None:
        text = str(msg)
        with self._lock:
            print(text)
            sys.stdout.flush()
            if self._fh is not None:
                self._fh.write(text + "\n")
                self._fh.flush()

    __call__ = log

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class MetricsWriter:
    """Scalar metrics as JSONL."""

    def __init__(self, out_dir: str, role: str = "local"):
        os.makedirs(out_dir, exist_ok=True)
        self.role = role
        self.path = os.path.join(out_dir, f"metrics_{role}.jsonl")
        self._lock = threading.Lock()

    def scalars(self, values: Dict[str, float], step: int) -> None:
        now = time.time()
        lines = "".join(json.dumps({"step": int(step), "tag": tag, "value": float(v), "t": now})
                        + "\n" for tag, v in values.items())
        with self._lock, open(self.path, "a") as f:
            f.write(lines)

    def read_all(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
