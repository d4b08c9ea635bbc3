"""Hard-example mining cache, the counterpart of
``soft_contrastive_learning_tpu/sampling/mining.py``.

``neighbor_order`` runs on the device right after the mining embed: one
fp32 Gram product and a stable argsort (``jnp.argsort`` is stable, so ties
keep the same order in both packages). ``MiningCache`` holds the order on
the host and answers the sampler's sorted-neighbour queries with one row
lookup.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch


def neighbor_order(features: torch.Tensor) -> torch.Tensor:
    """(C, D) float32 -> (C, C) int64: row i = cache positions sorted by
    ascending embedding distance to member i. Full fp32 product (the
    caller keeps TF32 off): a truncated product reshuffles near-ties."""
    f = features.float()
    sq = (f * f).sum(dim=1)
    dists = sq[None, :] - 2.0 * (f @ f.T)  # + sq[:, None] is constant per row
    return torch.argsort(dists, dim=1, stable=True)


class MiningCache:
    """The mining window's dataset indices and their (C, C) neighbour order.
    The port's refresh is order-only: the embeddings stay on the device and
    only the order crosses to the host (the JAX cache's host-features path
    serves the PCA branches, which come with the loss zoo)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._indices: Optional[np.ndarray] = None  # (C,) dataset indices
        self._order: Optional[np.ndarray] = None  # (C, C) from neighbor_order

    def refresh(self, indices: np.ndarray, order: np.ndarray) -> None:
        with self._lock:
            self._indices = np.asarray(indices)
            self._order = np.asarray(order)

    @property
    def ready(self) -> bool:
        with self._lock:
            return self._indices is not None and len(self._indices) > 0

    def sorted_neighbors(self, dataset_index: int) -> Optional[np.ndarray]:
        """Dataset indices of all cache members sorted by ascending
        embedding distance to ``dataset_index``'s cached embedding, or None
        if the index is not cached."""
        with self._lock:
            if self._indices is None:
                return None
            pos = np.flatnonzero(self._indices == dataset_index)
            if len(pos) == 0:
                return None
            return self._indices[self._order[pos[0]]]
