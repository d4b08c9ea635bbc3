"""Host-side tuple sampler: anchors -> (anchor, positives, negatives[,
other]) with each loss's geometric payload. Own copy of
``soft_contrastive_learning_tpu/sampling/tuples.py::TupleSampler``.

* positives: within ``max_pos_radius`` of the anchor and with yaw within
  ``max_yaw_diff`` (circular), topped up with hard positives: cache members
  that are valid positives but farthest in embedding space;
* negatives: outside ``min_neg_radius``; hard negatives are the cache
  members nearest in embedding space that are not excluded, with optional
  mutual exclusion of negative neighbourhoods;
* quadruplets (tuple shape (1, P, N, 1)) add an 'other negative' outside the
  neighbourhoods of the anchor and every chosen negative; without mutual
  exclusion the reference's 2-hop exclusion is kept (below);
* the payload follows ``LossConfig.distance_type``: 'anchor' (squared
  distances anchor-positives), 'pairwise' (squared distances among anchor
  and positives), 'swrd' and 'wrd' (geometric sigmoid weights), 'logratio'
  (squared distances to positives and negatives), 'wms' (the full-batch
  distance matrix), 'none' (no payload);
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


def _sigmoid(x: np.ndarray) -> np.ndarray:
    """Logistic sigmoid in float64 without overflow on either side."""
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    e = np.exp(x[~pos])
    out[~pos] = e / (1.0 + e)
    return out


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
        self.tuples = tuples
        self.loss = loss
        self.tuple_shape = tuple_shape
        self.xy = np.asarray(xy, dtype=float)
        self.yaw = np.asarray(yaw, dtype=float)
        self.rng = rng if rng is not None else np.random.default_rng(42)
        self.ref_tree = cKDTree(self.xy)
        self._p = tuple_shape[1]
        self._n = tuple_shape[2]
        self._quadruplet = len(tuple_shape) == 4

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
        members = [index] + positives + rand_negs + hard_neg
        if self._quadruplet:
            if not t.mutually_exclusive_negs:
                # The reference expands the neighbourhood of everything
                # excluded, the anchor's whole min_neg_radius neighbourhood
                # included: a 2-hop exclusion, kept for the payload's parity.
                for neg in list(excluded):
                    excluded.update(self._neighborhood(int(neg)).tolist())
            remaining = np.setdiff1d(
                np.arange(num_total), np.fromiter(excluded, dtype=int, count=len(excluded)))
            if len(remaining) == 0:
                return None
            members.append(int(self.rng.choice(remaining)))
        out = np.asarray(members, dtype=int)
        if len(out) != sum(self.tuple_shape):
            return None
        return out

    def _payload_one(self, tuple_indices: np.ndarray) -> Dict[str, np.ndarray]:
        """One tuple's geometric payload for the loss's ``distance_type``."""
        dt = self.loss.distance_type
        if dt in ("none", "wms"):  # wms: built over the whole batch in sample()
            return {}
        a_xy = self.xy[tuple_indices[0]]
        pos_xy = self.xy[tuple_indices[1 : 1 + self._p]]
        neg_xy = self.xy[tuple_indices[1 + self._p : 1 + self._p + self._n]]
        alpha, beta = self.loss.alpha, self.loss.beta
        if dt == "anchor":
            return {"sq_pos_geo_dists": np.sum((pos_xy - a_xy) ** 2, axis=1)}
        if dt == "pairwise":
            pts = np.concatenate([a_xy[None], pos_xy], axis=0)
            diff = pts[:, None, :] - pts[None, :, :]
            return {"pairwise_sq_geo_dists": np.sum(diff**2, axis=-1)}
        if dt == "swrd":
            pos_d = np.linalg.norm(pos_xy - a_xy, axis=1)
            neg_d = np.linalg.norm(neg_xy - a_xy, axis=1)
            return {"pos_weights": _sigmoid(-alpha * (pos_d - beta))[:, None],
                    "neg_weights": _sigmoid(-alpha * (beta - neg_d))[:, None]}
        if dt == "wrd":  # also prodwrd / sumwrd
            all_d = np.concatenate([np.linalg.norm(pos_xy - a_xy, axis=1),
                                    np.linalg.norm(neg_xy - a_xy, axis=1)])
            return {"pos_weights": _sigmoid(-alpha * (all_d - beta))[:, None],
                    "neg_weights": _sigmoid(-alpha * (beta - all_d))[:, None]}
        if dt == "logratio":
            return {"sq_pos_geo_dists": np.sum((pos_xy - a_xy) ** 2, axis=1),
                    "sq_neg_geo_dists": np.sum((neg_xy - a_xy) ** 2, axis=1)}
        raise ValueError(f"unknown distance_type {dt!r}")

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
        rows = [self._payload_one(row) for row in indices]
        payload = {k: np.stack([r[k] for r in rows]).astype(np.float32) for k in rows[0]}
        if self.loss.distance_type == "wms":
            # full-batch geographic distance matrix over every tuple member
            pts = self.xy[indices.reshape(-1)]
            diff = pts[:, None, :] - pts[None, :, :]
            payload["geo_dist_matrix"] = np.sqrt(
                np.maximum(np.sum(diff**2, axis=-1), 0.0)).astype(np.float32)
        return TupleSample(indices=indices, payload=payload, used_indices=used)
