"""Pickle IO for the descriptor index (``serve --index``) and the eval
plots' image writer.

Own copy of ``soft_contrastive_learning_tpu/utils/io.py::{load,save}_pickle``
and ``save_img`` (OpenCV imported when it is called). Unpickling runs code:
load only index files this program wrote.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def save_img(img: np.ndarray, path: str) -> None:
    """Write an RGB array to disk."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("writing an image needs OpenCV (cv2), which is not installed") from e
    cv2.imwrite(str(path), cv2.cvtColor(np.asarray(img, dtype=np.uint8), cv2.COLOR_RGB2BGR))
