"""The loss zoo of the PyTorch port against the JAX package: each of the 29
losses that need no streaming-PCA state, through both registries, on the
same numpy inputs in fp32, and the four incremental losses against a loss
PCA fitted by the JAX package's streaming PCA; the spectral primitives
against numpy's SVD and eigh in float64; the configs' derived fields.

Inputs: T = 2 tuples of 1 + 3 + 4 (quadruplets 1 + 3 + 3 + 1), D = 64. The
embeddings are random directions with norms in [0.2, 1], and the geometry
is a sampler's: positives 2-14 m from the anchor, negatives 16-60 m. The
payloads are built by the JAX sampler's own ``_payload_one``. Two settings
keep every loss's comparison informative: ``margin_1 = 1`` makes the
ntuplet hinges active on these inputs (at 0.1 they are zero, with no
gradient), and ``svd_dimensions = 3`` keeps the *rd family's kept singular
values a part of each tuple's rank, as the flagship's 10 of 12-24 are: at 10
the products take all 7 values, the smallest of which are the fp32
eigensolve's noise on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.losses import registry as jreg
from soft_contrastive_learning_tpu.losses.ms import tuple_labels as jax_tuple_labels
from soft_contrastive_learning_tpu.ops import spectral as jspec
from soft_contrastive_learning_tpu.sampling.tuples import TupleSampler as JaxTupleSampler
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.losses import registry as treg
from soft_contrastive_learning_torch.losses.ms import tuple_labels
from soft_contrastive_learning_torch.ops import spectral

torch.set_num_threads(1)  # tier-1 runs several workers on one host

T, P, N, D = 2, 3, 4, 64
KW = dict(margin_1=1.0, svd_dimensions=3)
ZOO = [n for n in treg.LOSS_NAMES if n not in tcfg.INCREMENTAL_LOSSES]
# the losses whose value goes through an eigensolve
SPECTRAL = {"pairwise_distance_neg_eigenvalue", "pairwise_huber_distance_neg_eigenvalue",
            "ntuplet_evmm", "residual_det", "residual_trace", "ms_sum", "swrd", "wrd",
            "prodwrd", "sumwrd"}


def _inputs(name, seed=0):
    loss = jcfg.LossConfig(name=name, **KW)
    tuples = jcfg.TupleConfig(positives_per_tuple=P, negatives_per_tuple=N)
    shape = jcfg.TrainConfig(tuples=tuples, loss=loss).tuple_shape
    s = sum(shape)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((T * s, D))
    emb *= rng.uniform(0.2, 1.0, (T * s, 1)) / np.linalg.norm(emb, axis=1, keepdims=True)
    ang = rng.uniform(0, 2 * np.pi, (T, s))
    rad = np.concatenate([np.zeros((T, 1)), rng.uniform(2, 14, (T, P)),
                          rng.uniform(16, 60, (T, s - 1 - P))], axis=1)
    xy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    xy = (xy + rng.uniform(0, 1000, (T, 1, 2))).reshape(T * s, 2)
    sampler = JaxTupleSampler(tuples, loss, shape, xy, np.zeros(T * s))
    rows = [sampler._payload_one(r) for r in np.arange(T * s).reshape(T, s)]
    payload = {k: np.stack([r[k] for r in rows]).astype(np.float32) for k in rows[0]}
    if loss.distance_type == "wms":
        diff = xy[:, None] - xy[None]
        payload["geo_dist_matrix"] = np.sqrt((diff**2).sum(-1)).astype(np.float32)
    return emb.astype(np.float32), payload, shape


def _jax_loss(name, emb, payload, shape, which):
    fn = jreg.build_loss(jcfg.LossConfig(name=name, **KW),
                         jcfg.TupleConfig(positives_per_tuple=P, negatives_per_tuple=N), T)
    pay = {k: jnp.asarray(v) for k, v in payload.items()}
    value, grad = jax.value_and_grad(
        lambda e: getattr(fn(jreg.split_batch(e, T, shape), pay, None), which))(jnp.asarray(emb))
    return float(value), np.asarray(grad)


def _port_loss(name, emb, payload, shape, which):
    fn = treg.build_loss(tcfg.LossConfig(name=name, **KW),
                         tcfg.TupleConfig(positives_per_tuple=P, negatives_per_tuple=N), T)
    e = torch.from_numpy(emb).requires_grad_()
    res = fn(treg.split_batch(e, T, shape), {k: torch.from_numpy(v) for k, v in payload.items()})
    value = getattr(res, which)
    (grad,) = torch.autograd.grad(value, e)
    return value.item(), grad.numpy()


@pytest.mark.parametrize("name", ZOO)
def test_loss_matches_jax(name):
    """Value within 5e-6 of max(1, |value|) (measured over 30 seeds: at most
    7.2e-7); gradient with respect to the embeddings within 5e-5 of its
    largest entry for the losses that go through an eigensolve (measured at
    most 1.69e-5, swrd and wrd: JAX's fp32 eigensolve, the port's float64
    one of the same fp32 Gram, and summation order compound through the
    product of singular values) and 2e-6 for the others (measured at most
    4.1e-7). The PN losses hold their pos and neg parts
    to the same. wms's mining thresholds make it discontinuous where a
    similarity ties a threshold within rounding (2 of the 30 seeds); seed
    0's inputs keep clear of that."""
    emb, payload, shape = _inputs(name)
    parts = ("total", "pos", "neg") if tcfg.LossConfig(name=name).pn_loss else ("total",)
    gtol = 5e-5 if name in SPECTRAL else 2e-6
    for which in parts:
        want_v, want_g = _jax_loss(name, emb, payload, shape, which)
        got_v, got_g = _port_loss(name, emb, payload, shape, which)
        assert np.isfinite(got_v) and np.isfinite(got_g).all()
        assert np.abs(want_g).max() > 0  # the comparison exercises a gradient
        assert abs(got_v - want_v) <= 5e-6 * max(1.0, abs(want_v)), (which, got_v, want_v)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=gtol * np.abs(want_g).max())


@pytest.mark.parametrize("name", ["pairwise_distance_neg_eigenvalue",
                                  "pairwise_huber_distance_neg_eigenvalue"])
def test_pn_part_alone_is_the_full_result_s(name):
    """The train step's updates ask a PN loss for one part: the same bits
    as that part of the full result, and the other part is not computed."""
    emb, payload, shape = _inputs(name)
    fn = treg.build_loss(tcfg.LossConfig(name=name, **KW),
                         tcfg.TupleConfig(positives_per_tuple=P, negatives_per_tuple=N), T)
    b = treg.split_batch(torch.from_numpy(emb), T, shape)
    pay = {k: torch.from_numpy(v) for k, v in payload.items()}
    full = fn(b, pay)
    for part, other in (("pos", "neg"), ("neg", "pos")):
        alone = fn(b, pay, part=part)
        assert torch.equal(alone.total, getattr(full, part))
        assert torch.equal(getattr(alone, part), getattr(full, part))
        assert getattr(alone, other) is None


@pytest.mark.parametrize("name", tcfg.INCREMENTAL_LOSSES)
def test_incremental_losses_raise_naming_the_next_slice(name):
    """The four incremental losses construct and build, as the JAX
    package's, with the streaming-PCA state as their third argument."""
    assert name in jreg.LOSS_NAMES
    cfg = tcfg.LossConfig(name=name)
    assert cfg.incremental and not cfg.pn_loss and cfg.distance_type == "none"
    assert callable(treg.build_loss(cfg, tcfg.TupleConfig(), 2))


# the incremental losses: L = loss_dim components, T tuples of 1 + P + N at
# width d (12: L + M + 1 = 13 > d, the Gram taken on the D side)
INC_L = 8


def _loss_pca(d, seed):
    """A loss PCA as the trainer starts one: the JAX streaming PCA fitted
    on 20 residual-like rows, then updated once; fp32 arrays as fed."""
    from soft_contrastive_learning_tpu.pca.incremental import StreamingPCA

    rng = np.random.default_rng(seed)
    pca = StreamingPCA(INC_L, 0.4)
    pca.init(0.3 * rng.standard_normal((20, d)))
    pca.update(0.3 * rng.standard_normal((14, d)))
    return {"s": pca.s, "v": pca.v, "m": pca.m, "seen": np.float32(pca.seen)}


def _inc_run(name, emb, st, jax_side):
    loss = (jcfg if jax_side else tcfg).LossConfig(name=name, loss_dim=INC_L)
    tuples = (jcfg if jax_side else tcfg).TupleConfig(positives_per_tuple=P,
                                                      negatives_per_tuple=N)
    if jax_side:
        from soft_contrastive_learning_tpu.losses.incremental import PCAState as JaxPCAState

        fn = jreg.build_loss(loss, tuples, T)
        state = JaxPCAState(**{k: jnp.asarray(v) for k, v in st.items()})

        def total(e):
            res = fn(jreg.split_batch(e, T, (1, P, N)), {}, state)
            return res.total, res.pca_in

        (value, pca_in), grad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(emb))
        return float(value), np.asarray(grad), np.asarray(pca_in)
    from soft_contrastive_learning_torch.losses.incremental import PCAState

    fn = treg.build_loss(loss, tuples, T)
    e = torch.from_numpy(emb).requires_grad_()
    res = fn(treg.split_batch(e, T, (1, P, N)), {},
             PCAState(**{k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}))
    (grad,) = torch.autograd.grad(res.total, e)
    return res.total.item(), grad.numpy(), res.pca_in.detach().numpy()


def _det_terms(name, emb, st):
    """The det variants' loss is a difference of two products of
    ``INC_L`` singular values, mean over tuples: the mean of |pos product|
    + |neg product|, in float64."""
    from soft_contrastive_learning_torch.losses import incremental as inc

    state = inc.PCAState(**{k: torch.as_tensor(np.asarray(v)).double() for k, v in st.items()})
    g = torch.from_numpy(emb).double().reshape(T, 1 + P + N, -1)
    a, pos, neg = g[:, :1], g[:, 1 : 1 + P], g[:, 1 + P :]
    if "residual" in name:
        pos, neg = pos - a, neg - a
    else:
        pos, neg = torch.cat([a, pos], 1), torch.cat([a, neg], 1)
    prods = [inc.stable_prod(inc.incremental_s(x, state)[:, :INC_L]) for x in (pos, neg)]
    return (prods[0].abs() + prods[1].abs()).mean().item()


@pytest.mark.parametrize("name", tcfg.INCREMENTAL_LOSSES)
@pytest.mark.parametrize("d", [64, 32, 12])
def test_incremental_loss_matches_jax(name, d):
    """Value within 1e-5 relative: of the value for the mm variants, of the
    products it is the difference of for the det variants (products of ~3e3
    that differ by ~9 at d = 64: both packages' fp32 Grams put them 3-5e-4
    of the difference, 5e-7 of the products, from a float64 evaluation);
    gradient with respect to the embeddings within 5e-5 of its largest
    entry (the spectral bound: JAX solves the fp32 Gram in fp32, the port
    in float64; measured at most 6.1e-6); ``pca_in``, the loss PCA's next
    update (the residuals, or the flat batch), within 1e-6."""
    rng = np.random.default_rng(d)
    emb = rng.standard_normal((T * (1 + P + N), d))
    emb = (emb * rng.uniform(0.2, 1.0, (len(emb), 1))
           / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    st = _loss_pca(d, d + 1)
    want_v, want_g, want_in = _inc_run(name, emb, st, jax_side=True)
    got_v, got_g, got_in = _inc_run(name, emb, st, jax_side=False)
    assert np.isfinite(got_v) and np.isfinite(got_g).all()
    assert np.abs(want_g).max() > 0
    scale = _det_terms(name, emb, st) if "det" in name else abs(want_v)
    assert abs(got_v - want_v) <= 1e-5 * scale, (got_v, want_v, scale)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=5e-5 * np.abs(want_g).max())
    want_rows = T * (P + N) if "residual" in name else T * (1 + P + N)
    assert got_in.shape == want_in.shape == (want_rows, d)
    np.testing.assert_allclose(got_in, want_in, rtol=0, atol=1e-6)


def test_loss_names_are_jax_s_in_its_order():
    assert treg.LOSS_NAMES == jreg.LOSS_NAMES and len(ZOO) == 29


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        treg.build_loss(tcfg.LossConfig(name="nope"), tcfg.TupleConfig(), 2)


@pytest.mark.parametrize("name", ZOO)
def test_derived_config_matches_jax(name):
    ours, theirs = tcfg.LossConfig(name=name), jcfg.LossConfig(name=name)
    for attr in ("distance_type", "pn_loss", "needs_other_neg", "incremental"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert (tcfg.TrainConfig(loss=ours).tuple_shape
            == jcfg.TrainConfig(loss=theirs).tuple_shape)
    defaults = {f: getattr(theirs, f) for f in ("margin_1", "margin_2", "lam", "ms_mining",
                                                 "loss_dim", "svd_dimensions", "d_max_squared",
                                                 "f_max_squared")}
    assert {f: getattr(ours, f) for f in defaults} == defaults


def test_tuple_labels_match_jax():
    np.testing.assert_array_equal(tuple_labels(3, 4, 5).numpy(),
                                  np.asarray(jax_tuple_labels(3, 4, 5)))


@pytest.mark.parametrize("m,d", [(7, 64), (25, 32), (5, 5), (9, 4)])
def test_svdvals_match_numpy_and_jax(m, d):
    """Singular values against numpy's float64 SVD and against JAX's, both
    Gram sides (m <= d and m > d) taken. Compared squared: an fp32
    eigensolve errs by ~eps * |Gram| in each eigenvalue, so a small singular
    value errs by that over 2s. Held within 1e-6 of the largest squared
    value (measured at most 1.1e-7)."""
    x = np.random.default_rng(m * d).standard_normal((3, m, d)).astype(np.float32)
    got = spectral.svdvals_descending(torch.from_numpy(x)).numpy().astype(np.float64)
    want = np.linalg.svd(x.astype(np.float64), compute_uv=False)
    jax_s = np.asarray(jspec.svdvals_descending(jnp.asarray(x))).astype(np.float64)
    assert got.shape == want.shape == jax_s.shape == (3, min(m, d))
    atol = 1e-6 * want.max() ** 2
    np.testing.assert_allclose(got**2, want**2, rtol=0, atol=atol)
    np.testing.assert_allclose(got**2, jax_s**2, rtol=0, atol=atol)
    np.testing.assert_array_equal(spectral.top_svdvals(torch.from_numpy(x), 4).numpy(),
                                  got[:, :4].astype(np.float32))


def test_gram_eigvals_and_trace_match_numpy():
    x = np.random.default_rng(1).standard_normal((2, 6, 40)).astype(np.float32)
    t = torch.from_numpy(x)
    want = np.linalg.eigvalsh(np.einsum("tmd,tnd->tmn", x.astype(np.float64), x))
    np.testing.assert_allclose(spectral.gram_eigvals(t).numpy(), want, rtol=0,
                               atol=1e-5 * want.max())
    np.testing.assert_allclose(spectral.min_eigenvalues(t).numpy(), want[:, 0], rtol=0,
                               atol=1e-5 * want.max())
    np.testing.assert_allclose(spectral.max_eigenvalues(t).numpy(), want[:, -1], rtol=1e-6)
    np.testing.assert_allclose(spectral.gram_trace(t).numpy(), want.sum(-1), rtol=1e-6)


def test_svdvals_gradient_finite_at_degenerate():
    """Duplicate rows: repeated singular values; the jitter keeps the
    eigensolve's gradient finite (JAX's test of the same name)."""
    x = torch.ones((1, 4, 6), requires_grad=True)
    spectral.top_svdvals(x, 3).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_stable_prod():
    """A direct fp32 product underflows the 1e-60 intermediate to 0; the
    log-space product recovers the representable 1e-22."""
    v = torch.tensor([1e-30, 1e-30, 1e38], dtype=torch.float32)
    np.testing.assert_allclose(spectral.stable_prod(v).item(), 1e-22, rtol=1e-3)
    np.testing.assert_allclose(spectral.stable_prod(torch.tensor([[2.0, 3.0, 4.0]])).numpy(),
                               [24.0], rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 3, 4), (1, 3, 3, 1)])
def test_split_batch_takes_the_other_negative_last(shape):
    e = torch.arange(2 * sum(shape) * 2, dtype=torch.float32).reshape(-1, 2)
    got = treg.split_batch(e, 2, shape)
    want = jreg.split_batch(jnp.asarray(e.numpy()), 2, shape)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
