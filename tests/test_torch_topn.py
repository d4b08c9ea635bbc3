"""The port's whitening PCA and top-N sweep against the JAX package's, on
the CPU, from numpy seeds.

- ``fit_pca``: eigenvector signs (and bases inside degenerate eigenspaces)
  differ between LAPACK builds, so fits are compared on spectra with
  distinct eigenvalues by sign-invariant quantities: explained variance
  (1e-4 relative), components after sign alignment (1e-4), the mean (1e-6)
  and pairwise distances of transformed rows (1e-4 relative), on both the
  Gram (N <= D) and covariance branches and both eigh routes (host float64,
  and the device's ``eigh`` at fp32).
- ``spatial_subsample``: equal.
- ``top_n_single`` / ``get_top_n``: exact inputs (multiples of 1/8, whose
  products are exact) give JAX's ids and distances (distances within 1e-6:
  square roots may differ by an ulp); whitened normals give its squared
  distances within 1e-4 of each query's N-th (the dense formula cancels in
  fp32 in both packages) and its ids outside near-ties within that; the
  geographic fields are equal. Both the dense route and the streamed one (K2's route, its
  plain version on the CPU; ``_TILED_THRESHOLD`` patched low in both
  packages).
- The D % 4 repair: ``topk_l2_streamed`` pads D = 66 and 130 with zero
  columns, bit-identical to the unpadded plain version on exact inputs.
"""

import numpy as np
import pytest
import torch

import soft_contrastive_learning_torch.evaluation.topn as ttopn
import soft_contrastive_learning_tpu.evaluation.topn as jtopn
from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_stream_plain
from soft_contrastive_learning_torch.ops.topk import topk_l2_streamed
from soft_contrastive_learning_torch.parallel.mesh import make_mesh
from soft_contrastive_learning_torch.pca import whiten as twhiten
from soft_contrastive_learning_torch.utils.io import load_pickle
from soft_contrastive_learning_tpu.pca.whiten import fit_pca as jax_fit_pca

torch.set_num_threads(1)  # tier-1 runs several workers on one host


def _spectrum_features(rng, n, d, r=20, noise=1e-3, decay=0.85):
    """(n, d) rows with r directions of distinct scale (4 x decay^i) in a
    random basis, plus isotropic noise, around a random mean."""
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0][:r]
    scales = 4.0 * decay ** np.arange(r)
    x = (rng.standard_normal((n, r)) * scales) @ basis
    x += noise * rng.standard_normal((n, d)) + rng.standard_normal(d)
    return x.astype(np.float32)


def _pairwise(x):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x[:, None] - x[None], axis=-1)


@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("n,d", [(40, 64), (120, 24)], ids=["gram", "covariance"])
def test_fit_pca_matches_jax_on_sign_invariant_quantities(n, d, host):
    rng = np.random.default_rng(n + d)
    x = _spectrum_features(rng, n, d)
    k = 12
    got = twhiten.fit_pca(x, k, host_eigh=host, device="cpu")
    want = jax_fit_pca(x, k, host_eigh=host)
    np.testing.assert_allclose(got.explained_variance.numpy(),
                               np.asarray(want.explained_variance), rtol=1e-4)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-6)
    comps, jcomps = got.components.numpy(), np.asarray(want.components)
    signs = np.sign((comps * jcomps).sum(1))
    np.testing.assert_allclose(comps * signs[:, None], jcomps, atol=1e-4)
    y = rng.standard_normal((30, d)).astype(np.float32) + x[:30]
    np.testing.assert_allclose(_pairwise(got.transform(y).numpy()),
                               _pairwise(want.transform(y)), rtol=1e-4, atol=1e-4)


def test_fit_pca_takes_host_eigh_at_its_threshold(monkeypatch):
    """Sides of 1024 and up go to float64 numpy; below, torch's eigh."""
    calls = []
    real = np.linalg.eigh
    monkeypatch.setattr(np.linalg, "eigh", lambda m: calls.append(m.dtype) or real(m))
    x = _spectrum_features(np.random.default_rng(0), 30, 40)
    twhiten.fit_pca(x, 4, device="cpu")
    assert calls == []
    monkeypatch.setattr(twhiten, "_HOST_EIGH_THRESHOLD", 30)
    twhiten.fit_pca(x, 4, device="cpu")
    assert calls == [np.float64]


def test_whitened_projection_nests_and_whiten_features():
    """A column slice of the transform at the largest D is the transform of
    a fit at the smaller D (what get_top_n relies on)."""
    rng = np.random.default_rng(3)
    x = _spectrum_features(rng, 50, 32)
    big = twhiten.fit_pca(x, 16, device="cpu").transform(x)
    small = twhiten.fit_pca(x, 8, device="cpu").transform(x)
    assert torch.equal(big[:, :8], small)
    assert torch.equal(twhiten.whiten_features(x, x, 8, device="cpu"), small)


@pytest.mark.parametrize("spacing", [0.0, 0.3, 1.0, 5.0])
@pytest.mark.parametrize("strict", [False, True])
def test_spatial_subsample_equals_jax(spacing, strict):
    rng = np.random.default_rng(4)
    xy = np.cumsum(rng.uniform(0, 0.6, (400, 2)), axis=0)
    xy[100:110] = xy[99]  # a stop: repeated poses
    assert ttopn.spatial_subsample(xy, spacing, strict) == \
        jtopn.spatial_subsample(xy, spacing, strict)


def _geo(rng, r, q):
    ref_xy = np.cumsum(rng.uniform(0, 0.5, (r, 2)), axis=0)
    query_xy = ref_xy[rng.integers(0, r, q)] + rng.normal(0, 1.5, (q, 2))
    return ref_xy, query_xy


def _assert_same_result(got, want, exact):
    assert [type(g) for g in got] == [type(w) for w in want]
    assert got[2].dtype == want[2].dtype == np.float32
    assert got[4].dtype == want[4].dtype
    assert got[3] == want[3] and got[5] == want[5]
    np.testing.assert_array_equal(got[4], want[4])
    if exact:
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
        return
    # squared distances within 1e-4 of each query's N-th: the dense formula
    # q^2 - 2qr + r^2 cancels in fp32, in both packages, so a small distance
    # is only as exact as the norms' scale allows
    got_sq, want_sq = np.asarray(got[2], np.float64) ** 2, np.asarray(want[2], np.float64) ** 2
    tol = 1e-4 * want_sq[:, -1:]
    assert (np.abs(got_sq - want_sq) <= tol).all()
    ids, jids = np.asarray(got[0]), np.asarray(want[0])
    gap = np.minimum(np.abs(np.diff(want_sq, axis=1, prepend=-np.inf)),
                     np.abs(np.diff(want_sq, axis=1, append=np.inf)))
    assert not ((ids != jids) & (gap > tol)).any()


@pytest.mark.parametrize("route", ["dense", "streamed"])
@pytest.mark.parametrize("spacing", [0.0, 1.0])
def test_top_n_single_matches_jax_on_exact_inputs(monkeypatch, route, spacing):
    rng = np.random.default_rng(5)
    r, q, d = 300, 20, 64
    refs = (rng.integers(-8, 9, (r, d)) / 8.0).astype(np.float32)
    refs[150:] = refs[:150]  # exact ties: both go to the smaller id
    queries = (rng.integers(-8, 9, (q, d)) / 8.0).astype(np.float32)
    ref_xy, query_xy = _geo(rng, r, q)
    if route == "streamed":
        monkeypatch.setattr(ttopn, "_TILED_THRESHOLD", 50)
        monkeypatch.setattr(jtopn, "_TILED_THRESHOLD", 50)
    got = ttopn.top_n_single(refs, queries, ref_xy, query_xy, spacing, n=25, device="cpu")
    want = jtopn.top_n_single(refs, queries, ref_xy, query_xy, spacing, n=25)
    _assert_same_result(got, want, exact=True)


def test_top_n_single_few_refs_and_mesh():
    rng = np.random.default_rng(6)
    refs = rng.standard_normal((10, 8)).astype(np.float32)
    ref_xy, query_xy = _geo(rng, 10, 3)
    assert ttopn.top_n_single(refs, refs[:3], ref_xy, query_xy, 0.0, n=25, device="cpu") is None
    assert jtopn.top_n_single(refs, refs[:3], ref_xy, query_xy, 0.0, n=25) is None
    # a mesh of one process searches as no mesh does (its ranks:
    # tests/test_torch_topk_sharded.py)
    one = make_mesh(devices=["cpu"])
    assert ttopn.top_n_single(refs, refs[:3], ref_xy, query_xy, 0.0, n=25, mesh=one) is None
    got = ttopn.top_n_single(refs, refs[:3], ref_xy, query_xy, 0.0, n=5, mesh=one)
    want = ttopn.top_n_single(refs, refs[:3], ref_xy, query_xy, 0.0, n=5, device="cpu")
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("route", ["dense", "streamed"])
def test_get_top_n_matches_jax(tmp_path, monkeypatch, route):
    """The sweep over whitened normals: the same settings written, each
    pickle JAX's within the stated tolerances."""
    rng = np.random.default_rng(7)
    d = 48
    # one distribution for the fit set and the refs; a slow decay keeps the
    # 32nd variance within 20x of the first, where fp32 eigh is accurate
    x = _spectrum_features(rng, 560, d, r=40, decay=0.95)
    pca, refs = x[:160], x[160:]
    queries = refs[rng.integers(0, 400, 30)] + 0.05 * rng.standard_normal((30, d))
    queries = queries.astype(np.float32)
    ref_xy, query_xy = _geo(rng, 400, 30)
    if route == "streamed":
        monkeypatch.setattr(ttopn, "_TILED_THRESHOLD", 100)
        monkeypatch.setattr(jtopn, "_TILED_THRESHOLD", 100)
    kw = dict(n=10, spacings=(0.0, 0.3, 1.0, 5.0), dims=(8, 16, 32, 64))
    got = ttopn.get_top_n(pca, refs, queries, ref_xy, query_xy, str(tmp_path / "port"),
                          "q_model", device="cpu", **kw)
    want = jtopn.get_top_n(pca, refs, queries, ref_xy, query_xy, str(tmp_path / "jax"),
                           "q_model", **kw)
    assert sorted(got) == sorted(want) and len(got) == 12  # dims <= 48, spacings 5 m -> 10+
    for setting in want:
        _assert_same_result(load_pickle(got[setting]), load_pickle(want[setting]), exact=False)
    # skip_existing: a second sweep writes nothing new
    again = ttopn.get_top_n(pca, refs, queries, ref_xy, query_xy, str(tmp_path / "port"),
                            "q_model", device="cpu", **kw)
    assert again == got


@pytest.mark.parametrize("d", [66, 130])
def test_streamed_top_k_pads_d_to_a_multiple_of_4(d):
    """K2 reads rows 16 bytes apart; topk_l2_streamed pads with zero
    columns, which add exact zeros: on exact inputs the padded route is the
    unpadded plain version bit for bit (ids and distances)."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.integers(-8, 9, (40, d)) / 8.0).float()
    r = torch.from_numpy(rng.integers(-8, 9, (500, d)) / 8.0).float()
    r[250:] = r[:250].clone()
    got_d, got_i = topk_l2_streamed(q, r, 25)
    want_d, want_i = topk_l2_stream_plain(q, r, 25)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    # normals: the same ranking outside near-ties, distances within 1e-6
    qn, rn = torch.randn((40, d), generator=torch.Generator().manual_seed(d)), torch.randn(
        (500, d), generator=torch.Generator().manual_seed(d + 1))
    got_d, got_i = topk_l2_streamed(qn, rn, 25)
    want_d, want_i = topk_l2_stream_plain(qn, rn, 25)
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=0)
    assert (got_i == want_i).float().mean() > 0.99
