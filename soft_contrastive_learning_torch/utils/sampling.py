"""Greedy farthest-point coverage sampling (reference util/sampling.py:7-27).
Own copy of ``soft_contrastive_learning_tpu/utils/sampling.py``.

Rewritten as a vectorized O(N * K) min-distance update instead of rebuilding a
KDTree per selected point (the reference rebuilds an sklearn KDTree on every
iteration, O(K^2 log K) total). Semantics: select points until no remaining
point is further than ``d_max`` from its nearest selected point.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def greedy(xy: np.ndarray, d_max: float, rng: Optional[np.random.Generator] = None) -> List[int]:
    xy = np.asarray(xy, dtype=float)
    n = xy.shape[0]
    if n == 0:
        return []
    if rng is None:
        rng = np.random.default_rng()
    first = int(rng.integers(n))
    selected = [first]
    # Running distance from every point to its nearest selected point.
    min_d = np.linalg.norm(xy - xy[first], axis=1)
    min_d[first] = -np.inf  # never reselect
    while len(selected) < n:
        i_max = int(np.argmax(min_d))
        if min_d[i_max] < d_max:
            break
        selected.append(i_max)
        d_new = np.linalg.norm(xy - xy[i_max], axis=1)
        min_d = np.minimum(min_d, d_new)
        min_d[i_max] = -np.inf
    return selected
