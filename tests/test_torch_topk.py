"""K2 (streaming top-k) and the dense top-k in the PyTorch port against the
JAX package: the Pallas kernel in interpret mode and ``topk_l2`` on the same
numpy inputs. Ids must be identical (ties to the smallest index). The
kernel itself is held to its plain version in ``test_torch_cuda.py``, on a
CUDA card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.ops.distances import cross_sq_dists as jax_cross_sq_dists
from soft_contrastive_learning_tpu.ops.pallas.topk_kernel import topk_l2_pallas
from soft_contrastive_learning_tpu.ops.topk import topk_l2 as jax_topk_l2
from soft_contrastive_learning_tpu.ops.topk import topk_l2_streamed as jax_topk_l2_streamed
from soft_contrastive_learning_torch.ops.distances import cross_sq_dists
from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda, topk_l2_stream_plain
from soft_contrastive_learning_torch.ops.topk import topk_l2, topk_l2_streamed

torch.set_num_threads(1)  # tier-1 runs several workers on one host

# fp32 on both sides with different summation orders: distances agree to a
# few ulps; 1e-5 relative leaves room and still catches any wrong neighbour.
RTOL = 1e-5


def _data(seed, q_n, r_n, d, duplicate=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    r = rng.standard_normal((r_n, d)).astype(np.float32)
    if duplicate:  # rows i and i + r_n/2 identical: exact ties
        r[r_n // 2 :] = r[: r_n // 2]
    return q, r


GRID = [  # (q_n, r_n, d, k, tile)
    (6, 100, 16, 5, 32),  # several tiles
    (3, 33, 8, 7, 16),  # ragged last tile
    (5, 50, 12, 25, 64),  # one tile, large k
    (1, 200, 4, 1, 64),  # k = 1
    (4, 10, 8, 12, 16),  # R < k: (inf, -1) padding
    (4, 64, 8, 20, 16),  # duplicated rows: ties
    (9, 300, 32, 128, 128),  # k at the kernel's maximum
]


@pytest.mark.parametrize("q_n,r_n,d,k,tile", GRID)
def test_plain_matches_pallas_interpret(q_n, r_n, d, k, tile):
    q, r = _data(q_n * r_n, q_n, r_n, d, duplicate=(r_n, k) == (64, 20))
    got_d, got_i = topk_l2_stream_plain(torch.from_numpy(q), torch.from_numpy(r), k)
    want_d, want_i = topk_l2_pallas(jnp.asarray(q), jnp.asarray(r), k, tile=tile,
                                    interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL, atol=0)


@pytest.mark.parametrize("q_n,r_n,d,k,tile", GRID)
def test_plain_and_dense_match_jax_topk_l2(q_n, r_n, d, k, tile):
    q, r = _data(q_n * r_n, q_n, r_n, d, duplicate=(r_n, k) == (64, 20))
    k_eff = min(k, r_n)
    want_d, want_i = jax_topk_l2(jnp.asarray(q), jnp.asarray(r), k_eff)
    tq, tr = torch.from_numpy(q), torch.from_numpy(r)
    for got_d, got_i in (topk_l2(tq, tr, k_eff), topk_l2_stream_plain(tq, tr, k)):
        np.testing.assert_array_equal(got_i[:, :k_eff].numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_d[:, :k_eff].numpy(), np.asarray(want_d),
                                   rtol=RTOL, atol=1e-6)


def test_duplicate_rows_tie_break():
    """Exact duplicates: the smaller index comes first, as lax.top_k does."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((5, 8)).astype(np.float32)
    r = torch.from_numpy(np.concatenate([base, base]))
    q = torch.from_numpy(base[:2] + 1e-3)
    for fn in (topk_l2, topk_l2_stream_plain):
        _, idx = fn(q, r, 2)
        for row in range(2):
            assert idx[row].tolist() == [row, row + 5]


def test_fewer_refs_than_k_pads():
    q, r = _data(5, 4, 10, 8)
    d, i = topk_l2_stream_plain(torch.from_numpy(q), torch.from_numpy(r), 12)
    assert d.shape == (4, 12) and i.shape == (4, 12)
    assert (i[:, 10:] == -1).all() and torch.isinf(d[:, 10:]).all()


def test_cross_sq_dists_matches_jax():
    q, r = _data(11, 7, 40, 24)
    got = cross_sq_dists(torch.from_numpy(q), torch.from_numpy(r)).numpy()
    want = np.asarray(jax_cross_sq_dists(jnp.asarray(q), jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("k", [6, 130])
def test_streamed_dispatch_on_cpu(k):
    """k <= 128 takes K2's plain version on the CPU, k > 128 the dense path;
    both agree with the JAX dispatcher, and nothing launches a kernel."""
    q, r = _data(12, 300, 400, 8)
    before = topk_l2_cuda.launches
    got_d, got_i = topk_l2_streamed(torch.from_numpy(q), torch.from_numpy(r), k)
    want_d, want_i = jax_topk_l2_streamed(jnp.asarray(q), jnp.asarray(r), k)
    assert topk_l2_cuda.launches == before
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL, atol=1e-6)

