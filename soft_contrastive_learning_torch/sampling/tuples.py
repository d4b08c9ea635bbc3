"""Host-side tuple sampler: anchors -> (anchor, positives, negatives) with
the wms geographic payload. Own copy of
``soft_contrastive_learning_tpu/sampling/tuples.py::TupleSampler``, trimmed
to the (1, P, N) tuple shape and the 'wms' payload (the other losses'
payloads and quadruplets come with the loss zoo).

* positives: within ``max_pos_radius`` of the anchor and with yaw within
  ``max_yaw_diff`` (circular), topped up with hard positives: cache members
  that are valid positives but farthest in embedding space;
* negatives: outside ``min_neg_radius``; hard negatives are the cache
  members nearest in embedding space that are not excluded, with optional
  mutual exclusion of negative neighbourhoods;
* faulty anchors are resampled, so the batch shape is fixed;
* all randomness flows through one ``numpy.random.Generator``.

Radius queries use ``scipy.spatial.cKDTree.query_ball_point`` with
``return_sorted=True`` (the port does not depend on scikit-learn). The
positives' random draw ``rng.choice(potential_pos, n)`` depends on the
order of the neighbour array, so this sampler matches the JAX one (whose
sklearn ``KDTree.query_radius`` returns tree order) draw for draw only when
both see sorted arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
from scipy.spatial import cKDTree

from soft_contrastive_learning_torch.core.config import LossConfig, TupleConfig
from soft_contrastive_learning_torch.sampling.mining import MiningCache

_MAX_RETRIES = 32


@dataclass
class TupleSample:
    """One sampled batch: (T, S) dataset indices + loss payloads."""

    indices: np.ndarray  # (T, S) int
    payload: Dict[str, np.ndarray] = field(default_factory=dict)
    used_indices: Set[int] = field(default_factory=set)


class TupleSampler:
    def __init__(
        self,
        tuples: TupleConfig,
        loss: LossConfig,
        tuple_shape: Tuple[int, ...],
        xy: np.ndarray,  # (M, 2) easting/northing
        yaw: np.ndarray,  # (M,)
        rng: Optional[np.random.Generator] = None,
    ):
        if len(tuple_shape) != 3 or loss.distance_type != "wms":
            raise NotImplementedError(
                "quadruplet tuples and non-wms payloads come with the loss-zoo slice")
        self.tuples = tuples
        self.loss = loss
        self.tuple_shape = tuple_shape
        self.xy = np.asarray(xy, dtype=float)
        self.yaw = np.asarray(yaw, dtype=float)
        self.rng = rng if rng is not None else np.random.default_rng(42)
        self.ref_tree = cKDTree(self.xy)
        self._p = tuple_shape[1]
        self._n = tuple_shape[2]

    def _within(self, index: int, radius: float) -> np.ndarray:
        return np.asarray(
            self.ref_tree.query_ball_point(self.xy[index], r=radius, return_sorted=True),
            dtype=np.int64)

    def _potential_positives(self, index: int) -> np.ndarray:
        near = self._within(index, self.tuples.max_pos_radius)
        near = near[near != index]
        yaw_d = np.abs(self.yaw[index] - self.yaw[near]) % (2 * math.pi)
        yaw_ok = np.minimum(yaw_d, 2 * math.pi - yaw_d) < self.tuples.max_yaw_diff
        return near[yaw_ok]

    def _neighborhood(self, index: int) -> np.ndarray:
        return self._within(index, self.tuples.min_neg_radius)

    def _sample_one(self, index: int, use_hard: bool,
                    cache: Optional[MiningCache]) -> Optional[np.ndarray]:
        t = self.tuples
        sorted_cache: Optional[np.ndarray] = None
        if use_hard and cache is not None and cache.ready:
            sorted_cache = cache.sorted_neighbors(index)

        potential_pos = self._potential_positives(index)
        if len(potential_pos) == 0:
            return None

        hard_pos: List[int] = []
        if sorted_cache is not None and t.hard_positives_per_tuple > 0:
            pos_set = set(potential_pos.tolist())
            for ci in reversed(sorted_cache):  # farthest in embedding first
                # the window can hold one dataset index twice
                if int(ci) in pos_set and int(ci) not in hard_pos:
                    hard_pos.append(int(ci))
                    if len(hard_pos) >= t.hard_positives_per_tuple:
                        break
        positives = self.rng.choice(potential_pos, self._p - len(hard_pos)).tolist() + hard_pos

        excluded: Set[int] = set(self._neighborhood(index).tolist())
        hard_neg: List[int] = []
        if sorted_cache is not None and t.hard_negatives_per_tuple > 0:
            for ci in sorted_cache:  # nearest in embedding first
                ci = int(ci)
                if ci not in excluded:
                    hard_neg.append(ci)
                    if t.mutually_exclusive_negs:
                        excluded.update(self._neighborhood(ci).tolist())
                    else:
                        excluded.add(ci)
                    if len(hard_neg) >= t.hard_negatives_per_tuple:
                        break

        num_total = len(self.yaw)
        rand_negs: List[int] = []
        while len(rand_negs) < self._n - len(hard_neg):
            if len(excluded) >= num_total:
                return None
            # rejection-sample first: excluded is small against the set
            next_i = -1
            for _ in range(32):
                cand = int(self.rng.integers(num_total))
                if cand not in excluded:
                    next_i = cand
                    break
            if next_i < 0:  # dense exclusion: draw from the exact remainder
                remaining = np.setdiff1d(
                    np.arange(num_total), np.fromiter(excluded, dtype=int, count=len(excluded)))
                if len(remaining) == 0:
                    return None
                next_i = int(self.rng.choice(remaining))
            rand_negs.append(next_i)
            if t.mutually_exclusive_negs:
                excluded.update(self._neighborhood(next_i).tolist())
            else:
                excluded.add(next_i)
        out = np.asarray([index] + positives + rand_negs + hard_neg, dtype=int)
        if len(out) != sum(self.tuple_shape):
            return None
        return out

    def sample(
        self,
        anchor_indices: Sequence[int],
        use_hard: bool = False,
        cache: Optional[MiningCache] = None,
    ) -> Optional[TupleSample]:
        """One batch of T tuples. A failed anchor is replaced by a random
        one, up to 32 times, so the batch shape stays fixed."""
        anchor_pool = np.arange(len(self.yaw))
        tuples_out: List[np.ndarray] = []
        used: Set[int] = set()
        for anchor in anchor_indices:
            member = self._sample_one(int(anchor), use_hard, cache)
            retries = 0
            while member is None and retries < _MAX_RETRIES:
                member = self._sample_one(int(self.rng.choice(anchor_pool)), use_hard, cache)
                retries += 1
            if member is None:
                return None  # pathological set; the caller skips the batch
            tuples_out.append(member)
            used.update(member.tolist())
        indices = np.stack(tuples_out)  # (T, S)
        # full-batch geographic distance matrix over every tuple member
        pts = self.xy[indices.reshape(-1)]
        diff = pts[:, None, :] - pts[None, :, :]
        geo = np.sqrt(np.maximum(np.sum(diff**2, axis=-1), 0.0)).astype(np.float32)
        return TupleSample(indices=indices, payload={"geo_dist_matrix": geo}, used_indices=used)
