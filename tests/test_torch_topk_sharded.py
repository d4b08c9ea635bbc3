"""``ops/topk.py::topk_l2_sharded`` and ``evaluation/topn.py::top_n_single``
with a mesh, on 2 and 4 gloo ranks spawned from the port package, against
JAX's ``topk_l2_sharded`` and ``top_n_single`` on meshes of as many of the
conftest's virtual CPU devices, and against the port's dense ``topk_l2``.

Inputs are multiples of 1/8, so every squared distance is exact in fp32 and
the rankings, ties included, are the same in every implementation: ids must
be equal and distances within 1e-6. The index has 45 rows, ragged over the
ranks, padded with rows of 1e9 as ``top_n_single`` pads it (JAX
``evaluation/topn.py:77-82``), and duplicated rows, whose ties go to the
smaller id.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.evaluation import topn as jtopn
from soft_contrastive_learning_tpu.ops.topk import topk_l2_sharded as jax_topk_l2_sharded
from soft_contrastive_learning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from soft_contrastive_learning_torch import dryrun
from soft_contrastive_learning_torch.launch.multihost import call_with_mesh, run_ranks
from soft_contrastive_learning_torch.ops.topk import topk_l2, topk_l2_sharded
from soft_contrastive_learning_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)  # tier-1 runs several workers on one host

RANK_TIMEOUT_S = 300  # each spawned rank's own deadline, and the group's
R, D, Q, K = 45, 16, 6, 7


def _eighths(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(11)
    refs = _eighths(rng, (R, D))
    refs[30] = refs[4]  # exact ties
    refs[44] = refs[17]
    queries = _eighths(rng, (Q, D))
    queries[0] = refs[4]  # a distance-0 tie at rank 0 of the result
    return queries, refs


def _padded(refs, n):
    pad = (-len(refs)) % n
    return np.concatenate([refs, np.full((pad, refs.shape[1]), 1e9, np.float32)])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_topk_equals_jax_and_the_dense_search(n):
    queries, refs = _inputs()
    refs_n = _padded(refs, n)
    ranks = run_ranks(dryrun.sharded_topk, n, (queries, refs_n, K), device="cpu",
                      timeout_s=RANK_TIMEOUT_S)
    mesh = jax_make_mesh(num_data=n, devices=jax.devices()[:n])
    with mesh:
        want_d, want_i = jax_topk_l2_sharded(jnp.asarray(queries), jnp.asarray(refs_n), K, mesh)
    dense_d, dense_i = topk_l2(torch.from_numpy(queries), torch.from_numpy(refs), K)
    for got_d, got_i, launches in ranks:  # every rank holds the whole result
        assert launches == 0  # the CPU runs K2's plain version
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_array_equal(got_i, dense_i.numpy())
        np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_d, dense_d.numpy(), rtol=0, atol=1e-6)
    assert ranks[0][1][0, 0] == 4  # the tie with row 30 goes to the smaller id


def test_one_rank_and_no_mesh_are_the_dense_search():
    queries, refs = _inputs()
    q, r = torch.from_numpy(queries), torch.from_numpy(refs)
    want = topk_l2(q, r, K)
    for got in (topk_l2_sharded(q, r, K), topk_l2_sharded(q, r, K, make_mesh(devices=["cpu"]))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [2, 4])
def test_top_n_single_on_a_mesh_equals_jax_s(n):
    queries, refs = _inputs()
    rng = np.random.default_rng(12)
    ref_xy = np.cumsum(rng.uniform(0.5, 2.0, (R, 2)), axis=0)
    query_xy = ref_xy[rng.integers(0, R, Q)] + rng.normal(0, 1.0, (Q, 2))
    args = (refs, queries, ref_xy, query_xy, 1.0)
    ranks = run_ranks(call_with_mesh, n,
                      ("soft_contrastive_learning_torch.evaluation.topn.top_n_single", args,
                       {"n": K}), device="cpu", timeout_s=RANK_TIMEOUT_S)
    mesh = jax_make_mesh(num_data=n, devices=jax.devices()[:n])
    with mesh:
        want = jtopn.top_n_single(*args, n=K, mesh=mesh)
    for got in ranks:
        assert got[0] == want[0] and got[3] == want[3] and got[5] == want[5]
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-9)
