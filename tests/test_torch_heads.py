"""The reduction heads of the port against the JAX package on the CPU:
spatial-pyramid pooling, the flattened map, the PCA projection, the dense
head, and ``EmbeddingNet`` for every ``reduction`` at ``vlad_cores`` 8 and
0 (64x80, fp32, the JAX init carried by ``params_from_flax``); ``remat``
and dropout of the port alone.

Tolerances: SPP and the flatten are exact (a max and a reshape of the same
fp32 values); the projection 1e-6 relative to the largest output (one fp32
product of width D); the dense head in eval mode 1e-5 relative; the whole
network 1e-5 relative to the largest output (13 fp32 convs, which the two
frameworks sum in other orders: ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.models import heads as jheads
from soft_contrastive_learning_tpu.models.model import create_model
from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
from soft_contrastive_learning_torch.core import config as tcfg
from soft_contrastive_learning_torch.models import heads
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.models.weights import flax_param_shapes, params_from_flax
from soft_contrastive_learning_torch.ops.kernels.winograd import winograd_conv_cuda

torch.set_num_threads(1)  # tier-1 runs several workers on one host

H, W = 64, 80
REDUCTIONS = ("none", "1fc", "2fc", "3fc", "pca", "spp")


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


def _cfgs(reduction, vlad_cores=8, out_dim=16, **kw):
    common = dict(vlad_cores=vlad_cores, reduction=reduction, out_dim=out_dim, image_height=H,
                  image_width=W, compute_dtype="float32", **kw)
    return jcfg.ModelConfig(use_pallas=False, **common), tcfg.ModelConfig(**common)


@pytest.mark.parametrize("h,w", [(11, 15), (7, 9), (4, 5)])
def test_spp_matches_jax_exactly(h, w):
    """Level-major, row-major bins, NHWC channels; the edges numpy's halves
    to even (11 -> [0, 6, 11] at level 1, 15 -> [0, 8, 15])."""
    x = np.random.default_rng(0).standard_normal((3, h, w, 32)).astype(np.float32)
    want = np.asarray(jheads.spatial_pyramid_pool(jnp.asarray(x), 3))
    got = heads.spatial_pyramid_pool(torch.from_numpy(x), 3).numpy()
    assert got.shape == (3, (1 + 4 + 16) * 32)
    np.testing.assert_array_equal(got, want)
    # level 1, top-left bin of the 11x15 map: rows 0-5, columns 0-7
    if (h, w) == (11, 15):
        np.testing.assert_array_equal(got[:, 32:64], x[:, :6, :8].max(axis=(1, 2)))


def test_pca_projection_matches_jax():
    rng = np.random.default_rng(1)
    x, v = rng.standard_normal((6, 300)), rng.standard_normal((20, 300))
    m, var = rng.standard_normal(300), rng.uniform(0.1, 3.0, 20)
    args = [a.astype(np.float32) for a in (x, v, m, var)]
    want = np.asarray(jheads.apply_pca_projection(*map(jnp.asarray, args)))
    got = heads.apply_pca_projection(*map(torch.from_numpy, args)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_fc_head_in_eval_mode_matches_jax(layers):
    x = np.random.default_rng(2).standard_normal((5, 96)).astype(np.float32)
    head = jheads.FCHead(num_layers=layers, out_dim=24)
    params = head.init(jax.random.key(3), jnp.asarray(x))["params"]
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x), train=False))
    port = heads.FCHead(layers, 96, out_dim=24)
    # a flax Dense kernel is (in, out), nn.Linear's weight (out, in)
    port.load_state_dict({k.replace("/kernel", ".weight").replace("/bias", ".bias"):
                          torch.from_numpy(np.array(v.T if k.endswith("kernel") else v))
                          for k, v in _flat(params).items()})
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (5, 24)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("vlad_cores", [8, 0])
def test_param_shapes_and_dims_are_jax_s(reduction, vlad_cores):
    j, t = _cfgs(reduction, vlad_cores)
    shapes = {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(jax.eval_shape(
        lambda: jax_init_params(j, jax.random.key(0))), sep="/").items()}
    assert flax_param_shapes(t) == shapes
    assert (t.descriptor_dim, t.output_dim) == (j.descriptor_dim, j.output_dim)
    with torch.device("meta"):
        state = EmbeddingNet(t).state_dict()
    assert len(state) == len(shapes)


def test_init_params_draws_the_dense_head_like_flax():
    """lecun_normal kernels (std 1/sqrt(fan_in), truncated at 2 sigma),
    zero biases."""
    _, t = _cfgs("2fc")
    state = init_params(t, 0)
    for name, fan_in in (("fc_head.fc1", 8 * 512), ("fc_head.fc2", 4096)):
        w = state[f"{name}.weight"]
        assert abs(w.std().item() * fan_in**0.5 - 1.0) < 0.02
        assert w.abs().max().item() * fan_in**0.5 <= 2 / 0.87962566103423978 + 1e-6
        assert not state[f"{name}.bias"].any()


def _pca_feed(dim, out_dim, seed=4):
    rng = np.random.default_rng(seed)
    v, _ = np.linalg.qr(rng.standard_normal((dim, out_dim)))
    return {"pca_components": v.T.astype(np.float32),
            "pca_mean": (0.01 * rng.standard_normal(dim)).astype(np.float32),
            "pca_variance": rng.uniform(1e-3, 1e-2, out_dim).astype(np.float32)}


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("vlad_cores", [8, 0])
def test_embedding_net_matches_jax(reduction, vlad_cores):
    """(output, full_out) of both networks from the JAX init, in eval mode
    (the dense heads' dropout masks come from other generators); with
    'pca' the output is the projection the step applies."""
    j, t = _cfgs(reduction, vlad_cores)
    model = create_model(j)
    params = jax_init_params(j, jax.random.key(0))
    imgs = np.random.default_rng(5).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    want_out, want_full = model.apply({"params": params}, jnp.asarray(imgs), train=False)
    port = EmbeddingNet(t)
    port.load_state_dict(params_from_flax(_flat(params), t))
    with torch.no_grad():
        got_out, got_full = port(torch.from_numpy(imgs))
    want_out, want_full = np.asarray(want_out), np.asarray(want_full)
    if reduction == "pca":
        feed = _pca_feed(t.descriptor_dim, t.out_dim)
        want_out = np.asarray(jheads.apply_pca_projection(
            jnp.asarray(want_full), *(jnp.asarray(feed[k]) for k in sorted(feed))))
        got_out = heads.apply_pca_projection(
            got_full, *(torch.from_numpy(feed[k]) for k in sorted(feed)))
    assert got_full.shape == want_full.shape == (2, t.descriptor_dim)
    assert got_out.shape == want_out.shape == (2, t.output_dim)
    for got, want in ((got_out.numpy(), want_out), (got_full.numpy(), want_full)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_flatten_is_the_nhwc_map():
    _, t = _cfgs("none", 0)
    model = EmbeddingNet(t)
    model.load_state_dict(init_params(t, 0))
    imgs = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, H, W, 3),
                                                              dtype=np.uint8))
    with torch.no_grad():
        out, full = model(imgs)
        fmap, _ = model.vgg16(imgs)
    assert fmap.shape == (2, H // 16, W // 16, 512) and model.netvlad is None
    assert torch.equal(full, fmap.reshape(2, -1)) and out is full


def test_one_fc_trains_as_jax_s():
    """``1fc`` has no dropout: training mode is eval mode, in both."""
    j, t = _cfgs("1fc")
    model = create_model(j)
    params = jax_init_params(j, jax.random.key(0))
    imgs = np.random.default_rng(7).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    want, _ = model.apply({"params": params}, jnp.asarray(imgs), train=True,
                          rngs={"dropout": jax.random.key(1)})
    port = EmbeddingNet(t)
    port.load_state_dict(params_from_flax(_flat(params), t))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(imgs), train=True, generator=torch.Generator())
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_dropout_draws_from_the_step_s_generator():
    """Rate 0.5: the kept values scaled by 2, the others 0; the same
    generator state gives the same mask, the global generator is not
    touched, and training without a generator raises."""
    x = torch.ones(4, 1000)
    gen = torch.Generator().manual_seed(0)
    before = torch.random.get_rng_state()
    a = heads.dropout(x, 0.5, gen)
    b = heads.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(torch.random.get_rng_state(), before)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs((a == 0).float().mean().item() - 0.5) < 0.03
    head = heads.FCHead(2, 8, out_dim=4, hidden_dim=16)
    with pytest.raises(ValueError, match="generator"):
        head(torch.ones(2, 8), train=True)
    assert not torch.equal(head(torch.ones(2, 8), train=True, generator=gen),
                           head(torch.ones(2, 8)))


@pytest.mark.parametrize("winograd", [False, True])
def test_remat_gives_the_same_gradients(winograd):
    """Recomputing each conv block in the backward changes nothing: the
    loss and every gradient equal the run that keeps its activations (on
    the CPU the Winograd convs take K4's plain version, which launches no
    kernel)."""
    grads, losses = [], []
    before = winograd_conv_cuda.launches
    for remat in (False, True):
        _, t = _cfgs("1fc", winograd=winograd, remat=remat)
        model = EmbeddingNet(t)
        model.load_state_dict(init_params(t, 0))
        imgs = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, H, W, 3),
                                                                  dtype=np.uint8))
        out, _ = model(imgs, train=True, generator=torch.Generator())
        loss = (out * out).sum()
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in model.named_parameters()})
    assert winograd_conv_cuda.launches == before
    assert losses[0] == losses[1]
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
