"""The port's width-packed stem (``ops/packed_stem.py``, ``VGG16(packed_stem=
True)``, the int8 stack's packed conv1_1 .. conv2_1 in ``models/quant.py``)
against the JAX package's and against the port's standard stem, on seeded
numpy inputs.

Tolerances: the packing functions are reindexing, equal exactly; the fp32
packed block within 1e-5 of its largest output (of JAX's packed block and
of the port's standard block: the packed conv sums the same products with
zeros in another order); the backbone's normalized features within 2e-5
(JAX's own test's bound); the int8 packed stem equal bit for bit to JAX's
eager ``_packed_int8_stem`` and the int8 stack's conv5_3 map to the port's
direct stack (integer sums, the same epilogue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_tpu.models import quant as jq
from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params
from soft_contrastive_learning_tpu.ops import packed_stem as jps
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.models import quant as tq
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.models.vgg16 import VGG16
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.ops import packed_stem as ps

torch.set_num_threads(1)  # tier-1 runs several workers on one host


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("fn,shape", [("pack_kernel", (3, 3, 3, 8)),
                                      ("pack_kernel", (3, 3, 8, 8)),
                                      ("pack_input", (2, 6, 8, 3)),
                                      ("repack_shifted", (2, 6, 4, 16)),
                                      ("packed_maxpool", (2, 6, 4, 16)),
                                      ("packed_maxpool_relu", (2, 6, 4, 16)),
                                      ("unpack_width", (2, 6, 4, 16))])
def test_packing_matches_jax(fn, shape):
    x = np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(getattr(ps, fn)(_t(x)).numpy(),
                                  np.asarray(getattr(jps, fn)(jnp.asarray(x))))


def test_pack_shapes():
    assert ps.pack_input(torch.zeros(1, 6, 8, 3)).shape == (1, 8, 5, 6)
    assert ps.pack_kernel(torch.zeros(3, 3, 3, 4)).shape == (3, 2, 6, 8)
    assert ps.repack_shifted(torch.zeros(1, 6, 4, 8)).shape == (1, 8, 5, 8)
    with pytest.raises(ValueError, match="even width"):
        ps.pack_input(torch.zeros(1, 6, 7, 3))


@pytest.mark.parametrize("b,h,w,f", [(2, 12, 16, 8), (3, 10, 6, 64), (1, 8, 30, 16)])
def test_packed_stem_block_matches_jax_and_standard(b, h, w, f):
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32) * 50
    k1 = (rng.standard_normal((3, 3, 3, f)) * 0.2).astype(np.float32)
    b1 = rng.standard_normal(f).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, f, f)) * 0.2).astype(np.float32)
    b2 = rng.standard_normal(f).astype(np.float32)
    got = ps.packed_stem_block(_t(x), _t(k1), _t(b1), _t(k2), _t(b2)).numpy()
    want = np.asarray(jps.packed_stem_block(*(jnp.asarray(a) for a in (x, k1, b1, k2, b2))))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    def conv(a, k, bias):
        return torch.nn.functional.conv2d(a, _t(k).permute(3, 2, 0, 1), _t(bias), padding=1)

    std = torch.relu(conv(_t(x).permute(0, 3, 1, 2), k1, b1))
    std = torch.relu(torch.nn.functional.max_pool2d(conv(std, k2, b2), 2))
    np.testing.assert_allclose(got, std.permute(0, 2, 3, 1).numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("hw", [(32, 48), (33, 47)])
def test_vgg16_packed_stem_matches_standard(hw):
    """The backbone with ``packed_stem`` on the standard one's parameters
    (the same state_dict keys): features within 2e-5; at odd sizes the
    standard stem runs (equal bits)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(
        np.float32) * 50 + 100)
    std = VGG16(compute_dtype=torch.float32)
    fast = VGG16(compute_dtype=torch.float32, packed_stem=True)
    assert list(std.state_dict()) == list(fast.state_dict())
    fast.load_state_dict(std.state_dict())
    with torch.no_grad():
        f_std, g_std = std(x)
        f_fast, g_fast = fast(x)
    if hw[0] % 2 or hw[1] % 2:
        assert torch.equal(f_fast, f_std)
    np.testing.assert_allclose(f_fast.numpy(), f_std.numpy(), rtol=0, atol=2e-5)
    assert g_fast.shape == g_std.shape


def test_embedding_packed_stem_matches_jax():
    """EmbeddingNet(ModelConfig(packed_stem=True)) against JAX's packed
    model on the same flax init: descriptors within 1e-5."""
    common = dict(vlad_cores=4, image_height=32, image_width=48, compute_dtype="float32",
                  packed_stem=True)
    jcfg, cfg = JaxModelConfig(use_pallas=False, **common), ModelConfig(**common)
    from flax import traverse_util

    from soft_contrastive_learning_tpu.models.model import create_model

    jparams = jax_init_params(jcfg, jax.random.key(1))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jparams, sep="/").items()}
    model = EmbeddingNet(cfg)
    model.load_state_dict(params_from_flax(flat, cfg))
    x = np.random.default_rng(3).random((2, 32, 48, 3), np.float32) * 255
    with torch.no_grad():
        got = model(_t(x))[0].numpy()
    want = np.asarray(create_model(jcfg).apply({"params": jparams}, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def int8_setup():
    common = dict(vlad_cores=4, image_height=48, image_width=64, compute_dtype="float32")
    jcfg, cfg = JaxModelConfig(use_pallas=False, **common), ModelConfig(**common)
    from flax import traverse_util

    jparams = jax_init_params(jcfg, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jparams, sep="/").items()}
    params = params_from_flax(flat, cfg)
    x = np.random.default_rng(0).random((4, 48, 64, 3), np.float32) * 255.0
    scales = tq.calibrate_scales(params, x, "cpu")
    return jparams, params, x, scales


def test_int8_packed_stem_matches_jax_eager(int8_setup):
    """conv2_2's int8 input from the port's packed stem equals JAX's eager
    ``_packed_int8_stem`` (fed JAX's requant of the same images)."""
    jparams, params, x, scales = int8_setup
    vgg = jparams["vgg16"]
    a = jnp.asarray(x) - vgg["average_rgb"].astype(jnp.float32)
    want = jq._packed_int8_stem(vgg, scales, jq._requant(a, scales[jq.CONV_NAMES[0]]))
    stack = tq.QuantizedConvStack(params, scales, "cpu", packed_stem=True)
    np.testing.assert_array_equal(stack.packed_stem(_t(x)).numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,packed", [((48, 64), True), ((32, 40), True), ((48, 66), False)])
def test_int8_packed_stack_equals_direct(int8_setup, hw, packed):
    """The whole int8 stack with ``packed_stem`` equals the direct one bit
    for bit; where W % 4 != 0 the direct stem runs (JAX's condition)."""
    _, params, _, scales = int8_setup
    x = np.random.default_rng(hw[1]).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    stack = tq.QuantizedConvStack(params, scales, "cpu", packed_stem=True)
    assert (stack.packed != []) and (hw[1] % 4 == 0) == packed
    direct = tq.QuantizedConvStack(params, scales, "cpu")
    assert torch.equal(stack(x), direct(x))
    cfg = ModelConfig(vlad_cores=4, image_height=hw[0], image_width=hw[1],
                      compute_dtype="float32", packed_stem=True)
    emb = tq.QuantizedEmbedder(cfg, params, scales=scales, device="cpu")
    assert emb.stack.packed
    ref = tq.QuantizedEmbedder(cfg.__class__(**{**cfg.__dict__, "packed_stem": False}), params,
                               scales=scales, device="cpu")
    assert torch.equal(emb(x), ref(x))


def test_packed_stem_from_fresh_init_trains_the_same_parameters():
    """``init_params`` of a packed configuration is the standard one's
    (checkpoints do not change)."""
    a = init_params(ModelConfig(vlad_cores=4, packed_stem=True), 0)
    b = init_params(ModelConfig(vlad_cores=4), 0)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
