"""Mining order and tuple sampling in the PyTorch port against the JAX
package.

``neighbor_order`` runs on features whose products are exact in fp32
(multiples of 1/8, with duplicated rows), so distances tie exactly and
both stable argsorts must give the same order, ties included.

The samplers: the port queries ``cKDTree.query_ball_point(...,
return_sorted=True)``; the JAX one sklearn's ``KDTree.query_radius``, whose
neighbour arrays come in tree order. ``rng.choice(potential_pos, n)``
depends on that order, so here, and in this file only, the JAX sampler's
tree is wrapped in a shim that sorts what ``query_radius`` returns. With
it, the two samplers draw the same tuples from the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.neighbors import KDTree

import soft_contrastive_learning_tpu.sampling.tuples as jax_tuples
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.data.pipeline import ToyCitySource as JaxToyCitySource
from soft_contrastive_learning_tpu.sampling.mining import MiningCache as JaxMiningCache
from soft_contrastive_learning_tpu.sampling.mining import neighbor_order as jax_neighbor_order
from soft_contrastive_learning_tpu.utils.meta import get_xy as jax_get_xy
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
from soft_contrastive_learning_torch.sampling.mining import MiningCache, neighbor_order
from soft_contrastive_learning_torch.sampling.tuples import TupleSampler
from soft_contrastive_learning_torch.utils.meta import get_xy, get_yaw

# the CLI's toy city (120 poses on a 150 m loop, ~7.9 m apart)
CITY = dict(num_points=120, radius=150.0, seed=42)


class SortedKDTree:
    """sklearn's KDTree with sorted ``query_radius`` results."""

    def __init__(self, xy):
        self._tree = KDTree(xy)

    def query_radius(self, x, r):
        found = self._tree.query_radius(x, r=r)
        out = np.empty(len(found), dtype=object)
        out[:] = [np.sort(a) for a in found]
        return out


def _eighths(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("c,d", [(16, 8), (120, 64), (37, 5)])
def test_neighbor_order_matches_jax_ties_included(c, d):
    rng = np.random.default_rng(c + d)
    f = _eighths(rng, (c, d))
    f[c // 2 :] = f[: c - c // 2]  # duplicated rows: exact ties in every row
    got = neighbor_order(torch.from_numpy(f)).numpy()
    want = np.asarray(jax_neighbor_order(jnp.asarray(f)))
    assert got.shape == (c, c)
    np.testing.assert_array_equal(got, want)
    # the nearest is the lowest-indexed copy of the row itself: a stable sort
    first_copy = [int(np.flatnonzero((f == f[i]).all(axis=1))[0]) for i in range(c)]
    np.testing.assert_array_equal(got[:, 0], first_copy)


def test_mining_cache_answers_like_jax():
    rng = np.random.default_rng(0)
    f = _eighths(rng, (30, 16))
    idx = rng.permutation(200)[:30]
    ours, theirs = MiningCache(), JaxMiningCache()
    assert not ours.ready
    ours.refresh(idx, neighbor_order(torch.from_numpy(f)).numpy())
    # the JAX trainer's order-only refresh (its host matvec fallback sorts
    # with an unstable argsort, so its tie order is not defined)
    theirs.refresh(None, idx, order=np.asarray(jax_neighbor_order(jnp.asarray(f))))
    assert ours.ready
    for i in idx[:10]:
        np.testing.assert_array_equal(ours.sorted_neighbors(i), theirs.sorted_neighbors(i))
    assert ours.sorted_neighbors(999) is None


def _samplers(seed, mp):
    mp.setattr(jax_tuples, "KDTree", SortedKDTree)
    meta = ToyCitySource(**CITY).epoch_meta("train_ref", 0)
    jmeta = JaxToyCitySource(**CITY).epoch_meta("train_ref", 0)
    assert meta == jmeta
    ours = TupleSampler(tcfg.TupleConfig(), tcfg.LossConfig(), (1, 12, 12), get_xy(meta),
                        get_yaw(meta), rng=np.random.default_rng(seed))
    theirs = jax_tuples.TupleSampler(jcfg.TupleConfig(), jcfg.LossConfig(), (1, 12, 12),
                                     jax_get_xy(jmeta), get_yaw(jmeta),
                                     rng=np.random.default_rng(seed))
    return meta, ours, theirs


@pytest.mark.parametrize("with_cache", [False, True])
def test_sampler_draws_the_jax_tuples(with_cache, monkeypatch):
    meta, ours, theirs = _samplers(7, monkeypatch)
    anchors = ToyCitySource(**CITY).anchor_indices("train_ref", 1, 0)
    caches = (None, None)
    if with_cache:  # a refreshed window of 100 rolling + 20 upcoming, as the trainer mines
        rng = np.random.default_rng(3)
        idx = np.concatenate([np.arange(100), anchors[:20]])
        f = _eighths(rng, (len(idx), 32))
        caches = (MiningCache(), JaxMiningCache())
        caches[0].refresh(idx, neighbor_order(torch.from_numpy(f)).numpy())
        caches[1].refresh(None, idx, order=np.asarray(jax_neighbor_order(jnp.asarray(f))))
    for start in range(0, 40, 2):  # 20 batches of 2 tuples, the flagship's B = 50
        a = anchors[start : start + 2]
        got = ours.sample(a, use_hard=True, cache=caches[0])
        want = theirs.sample(a, use_hard=True, cache=caches[1])
        assert got.indices.shape == (2, 25)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.payload["geo_dist_matrix"],
                                      want.payload["geo_dist_matrix"])
        assert got.used_indices == want.used_indices
    assert ours.rng.integers(1 << 30) == theirs.rng.integers(1 << 30)  # same draws consumed


def test_hard_members_come_from_the_cache(monkeypatch):
    """With a ready cache the last 6 positives and 6 negatives of each tuple
    are the cache's farthest valid positives and nearest negatives."""
    meta, ours, _ = _samplers(1, monkeypatch)
    idx = np.arange(120)
    f = _eighths(np.random.default_rng(4), (120, 32))
    cache = MiningCache()
    cache.refresh(idx, neighbor_order(torch.from_numpy(f)).numpy())
    s = ours.sample([10, 50], use_hard=True, cache=cache)
    for row in s.indices:
        order = cache.sorted_neighbors(row[0])
        hard_neg = row[1 + 12 + 6 :]
        assert set(hard_neg) <= set(order[:60].tolist())
        d = np.linalg.norm(ours.xy[hard_neg] - ours.xy[row[0]], axis=1)
        assert (d > 15.0).all()
    geo = s.payload["geo_dist_matrix"]
    assert geo.shape == (50, 50) and geo.dtype == np.float32
    np.testing.assert_allclose(np.diag(geo), 0.0)
