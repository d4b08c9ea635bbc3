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
from soft_contrastive_learning_torch.ops.kernels.topk import (
    TILE_ROWS,
    tf32_round,
    tf32_split,
    topk_l2_3xtf32_plain,
    topk_l2_cuda,
    topk_l2_stream_plain,
)
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



# ---------------------------------------------------------------- K2's 3xTF32 arithmetic


def _eighths(seed, shape):
    """Multiples of 1/8 in [-1, 1]: exact products and sums in fp32, and no
    bits below tf32's (the lo parts are 0)."""
    return (np.random.default_rng(seed).integers(-8, 9, shape) / 8.0).astype(np.float32)


def test_tf32_split_is_exact_and_hi_has_11_significant_bits():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4000), rng.standard_normal(1000) * 1e-30,
                        rng.standard_normal(1000) * 1e30, [0.0, -0.0, 1.0, -1.5, 3e-45]])
    x = torch.from_numpy(x.astype(np.float32))
    hi, lo = tf32_split(x)
    assert torch.equal(hi + lo, x)  # exact: lo holds the dropped bits
    bits = hi.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()  # 1 implicit + 10 stored mantissa bits at most
    assert (hi.abs() <= x.abs()).all() and (torch.sign(hi) * torch.sign(x) >= 0).all()
    # lo has at most 13 significant bits; its tf32 rounding keeps 11, nearest
    lo_t = tf32_round(lo)
    assert ((lo_t.view(torch.int32) & 0x1FFF) == 0).all()
    ulp = torch.ldexp(torch.ones_like(lo), torch.frexp(lo.abs().clamp_min(1e-38))[1] - 11)
    assert ((lo_t - lo).abs() <= ulp / 2).all()
    # the split of a tf32 value is the value itself and 0
    hi2, lo2 = tf32_split(hi)
    assert torch.equal(hi2, hi) and (lo2 == 0).all()


def _near_tie_gaps(d):
    """Per rank, the squared-distance gap to the nearer of its neighbours."""
    sq = d.astype(np.float64) ** 2
    with np.errstate(invalid="ignore"):  # inf padding: no neighbour to tie with
        steps = np.abs(np.diff(sq, axis=1))
    left = np.concatenate([np.full((len(sq), 1), np.inf), steps], 1)
    right = np.concatenate([steps, np.full((len(sq), 1), np.inf)], 1)
    return np.minimum(left, right)


@pytest.mark.parametrize("q_n,r_n,d,k,tile", GRID)
def test_3xtf32_emulation_matches_pallas_interpret(q_n, r_n, d, k, tile):
    """K2's split arithmetic against the TPU kernel (Precision.HIGHEST). On
    eighths both are exact: ids identical and distances bit-equal. On
    normals the two products differ in the last bits: ids identical outside
    near-ties (neighbours within 1e-5 in squared distance, relative), and
    distances within RTOL."""
    qe, re_ = _eighths(q_n * r_n, (q_n, d)), _eighths(q_n * r_n + 1, (r_n, d))
    if (r_n, k) == (64, 20):
        re_[r_n // 2 :] = re_[: r_n // 2]
    got_d, got_i = topk_l2_3xtf32_plain(torch.from_numpy(qe), torch.from_numpy(re_), k)
    want_d, want_i = topk_l2_pallas(jnp.asarray(qe), jnp.asarray(re_), k, tile=tile,
                                    interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))

    q, r = _data(q_n * r_n, q_n, r_n, d, duplicate=(r_n, k) == (64, 20))
    got_d, got_i = topk_l2_3xtf32_plain(torch.from_numpy(q), torch.from_numpy(r), k)
    want_d, want_i = topk_l2_pallas(jnp.asarray(q), jnp.asarray(r), k, tile=tile,
                                    interpret=True)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    finite = np.isfinite(want_d)
    scale = max(1.0, float((want_d[finite] ** 2).max()))
    differ = got_i.numpy() != want_i
    assert not (differ & (_near_tie_gaps(want_d) > 1e-5 * scale)).any()
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=RTOL, atol=0)


def test_3xtf32_reads_the_low_mantissa_bits():
    """Refs equal in their tf32 part and different only below it: the hi
    product alone ranks them all equal (ids in order), the split ranks them
    by their low bits, as the plain fp32 version does."""
    d, n = 64, 40
    s = np.random.default_rng(5).permutation(n)
    r = (0.5 + s[:, None] * 2.0**-17 + np.zeros((n, d))).astype(np.float32)  # bits below 2^-11
    q = torch.ones((2, d))
    rt = torch.from_numpy(r)
    assert (tf32_split(rt)[0] == 0.5).all()
    _, got = topk_l2_3xtf32_plain(q, rt, 10)
    _, want = topk_l2_stream_plain(q, rt, 10)
    assert torch.equal(got, want)
    assert got[0].tolist() == np.argsort(-s)[:10].tolist()
    _, hi_only = topk_l2_stream_plain(q, tf32_split(rt)[0], 10)
    assert hi_only[0].tolist() == list(range(10))


def _block_lists(scores, n_lists, p, tile):
    """K2's partial kernel in plain form, for one query tile: list b is block
    b, rank b % 2 of cluster b // 2; the clusters split the pairs of
    ``tile``-row ref tiles evenly and in order, the rank takes the even or
    odd tile of each pair (past the last tile: none). Each block meets its
    refs in ascending id order and keeps the p best by strict insertion (an
    equal score stays behind). Returns per query the n_lists sorted (score,
    id) lists."""
    n_refs = scores.shape[1]
    n_tiles = -(-n_refs // tile)
    n_pairs = -(-n_tiles // 2)
    n_clusters = n_lists // 2
    out = []
    for row in scores:
        lists = []
        for b in range(n_lists):
            c, rank = divmod(b, 2)
            best = []
            for pair in range(c * n_pairs // n_clusters, (c + 1) * n_pairs // n_clusters):
                t = 2 * pair + rank
                if t >= n_tiles:
                    continue
                for i in range(t * tile, min((t + 1) * tile, n_refs)):
                    s = float(row[i])
                    if len(best) == p and not s > best[-1][0]:
                        continue
                    pos = len(best) if len(best) < p else p - 1
                    while pos > 0 and s > best[pos - 1][0]:
                        pos -= 1
                    best = best[:pos] + [(s, i)] + best[pos:]
                    best = best[:p]
            lists.append(best)
        out.append(lists)
    return out


def _merge(lists, k):
    """The merge kernel in plain form: k rounds, each taking the best head by
    (score descending, id ascending); (-inf, -1) once the lists run out."""
    heads = [0] * len(lists)
    res = []
    for _ in range(k):
        cand = [(-lst[h][0], lst[h][1], j) for j, (lst, h) in enumerate(zip(lists, heads))
                if h < len(lst)]
        if not cand:
            res.append((-np.inf, -1))
            continue
        neg, i, j = min(cand)
        heads[j] += 1
        res.append((-neg, i))
    return res


@pytest.mark.parametrize("r_n,n_lists,tile,k", [
    (300, 2, 16, 5),     # one cluster, many tile pairs
    (300, 6, 16, 20),    # three clusters, ragged last tile, the last pair whole
    (270, 8, 16, 7),     # 17 tiles: the last pair has no odd tile
    (40, 4, 16, 12),     # fewer tiles than blocks would take: two clusters
    (10, 2, 16, 12),     # R < k: (-inf, -1) padding
    (500, 132, 4, 3),    # 132 lists, 125 tiles: clusters of one pair
    (2000, 10, TILE_ROWS, 128),  # the kernel's tile, k at its maximum
])
def test_block_lists_merged_equal_the_one_pass_top_k(r_n, n_lists, tile, k):
    """The persistent design's order of work, in plain form: per-block
    running lists over interleaved tile runs, then the merge, give the
    one-pass stable top-k, ties (duplicated rows) included."""
    q = torch.from_numpy(_eighths(r_n + n_lists, (3, 8)))
    r = torch.from_numpy(_eighths(r_n + n_lists + 1, (r_n, 8)))
    r[r_n // 2 : r_n // 2 + r_n // 4] = r[: r_n // 4].clone()  # duplicates: exact ties
    scores = (2.0 * (q @ r.T) - (r * r).sum(1)[None, :]).numpy()
    p = min(k, r_n)
    _, want_i = topk_l2_stream_plain(q, r, k)
    top = np.sort(scores, axis=1)[:, ::-1]
    for row, lists in enumerate(_block_lists(scores, n_lists, p, tile)):
        merged = _merge(lists, k)
        assert [i for _, i in merged] == want_i[row].tolist()
        assert [s for s, i in merged if i >= 0] == top[row, :p].tolist()
