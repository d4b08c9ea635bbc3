"""Checkpoint registry: experiment codes -> checkpoint paths, as a JSON file
(``{"wms": ["/runs/a/epoch-checkpoint-2", ...], ...}``). Own copy of
``soft_contrastive_learning_tpu/utils/experiments.py``, reading the same
file and the same environment variable, so both packages share a registry.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

_DEFAULT_REGISTRY_ENV = "SCL_TPU_EXPERIMENTS_JSON"


def registry_path(explicit: Optional[str] = None) -> str:
    if explicit:
        return explicit
    return os.environ.get(_DEFAULT_REGISTRY_ENV, "experiments.json")


def load_registry(path: Optional[str] = None) -> Dict[str, List[str]]:
    p = registry_path(path)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def save_registry(reg: Dict[str, List[str]], path: Optional[str] = None) -> None:
    with open(registry_path(path), "w") as f:
        json.dump(reg, f, indent=2, sort_keys=True)


def get_checkpoints(code: str, path: Optional[str] = None) -> List[str]:
    """Checkpoint paths registered under an experiment code."""
    return load_registry(path).get(code, [])


def register_checkpoint(code: str, checkpoint: str, path: Optional[str] = None) -> None:
    reg = load_registry(path)
    reg.setdefault(code, [])
    if checkpoint not in reg[code]:
        reg[code].append(checkpoint)
    save_registry(reg, path)


def checkpoint_code_name(checkpoint_path: str) -> str:
    """Display name of a checkpoint: its parent directory's name with the
    dots taken out, then ``_e`` and the path's last character (the epoch)."""
    cp_name = checkpoint_path.split("/")[-2]
    cp_name = "".join(os.path.basename(cp_name).split("."))
    return cp_name + f"_e{checkpoint_path[-1]}"
