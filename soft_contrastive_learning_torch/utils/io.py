"""Pickle IO for the descriptor index (``serve --index``).

Own copy of ``soft_contrastive_learning_tpu/utils/io.py::{load,save}_pickle``.
Unpickling runs code: load only index files this program wrote.
"""

from __future__ import annotations

import pickle
from typing import Any


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
