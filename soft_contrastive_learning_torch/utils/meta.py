"""Metadata helpers over the CSV dict-of-lists contract. Own copy of
``soft_contrastive_learning_tpu/utils/meta.py``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def get_xy(meta: Dict[str, List[str]]) -> np.ndarray:
    """(N, 2) float array of (easting, northing)."""
    return np.stack([np.asarray(meta["easting"], dtype=float),
                     np.asarray(meta["northing"], dtype=float)], axis=1)


def get_yaw(meta: Dict[str, List[str]]) -> np.ndarray:
    """(N,) float yaw array."""
    return np.asarray(meta["yaw"], dtype=float)


def image_keys(meta: Dict[str, List[str]], indices) -> List[tuple]:
    """(date, folder, t) triples identifying images."""
    return [(meta["date"][i], meta["folder"][i], meta["t"][i]) for i in indices]
