"""VGG16 + NetVLAD-64 in the PyTorch port against the JAX package, both
loaded from the committed trained artifact (``flagship_trained.npz``), at
64x80 input in fp32."""

import numpy as np
import pytest
import torch

from soft_contrastive_learning_tpu import flagship
from soft_contrastive_learning_tpu.core.config import ModelConfig as JaxModelConfig
from soft_contrastive_learning_tpu.models.model import create_model
from soft_contrastive_learning_tpu.models.vgg16 import VGG16 as JaxVGG16
from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.models.weights import (
    TRAINED_PARAMS_PATH,
    load_trained_params,
    params_from_flax,
)

torch.set_num_threads(1)  # tier-1 runs several workers on one host

H, W = 64, 80
# fp32 convs on both CPUs, 13 layers deep: the channel-normalized map (|v|
# <= 1) differs by ~1e-6 from summation order; 1e-4 is the stated bound.
# The unit-norm descriptor must keep cosine >= 0.99999.
FEATURE_ATOL = 1e-4
MIN_COSINE = 0.99999


@pytest.fixture(scope="module")
def models():
    jcfg = JaxModelConfig(image_height=H, image_width=W, compute_dtype="float32",
                          use_pallas=False)
    jparams = flagship.load_trained_params(jcfg)
    cfg = ModelConfig(image_height=H, image_width=W, compute_dtype="float32")
    model = EmbeddingNet(cfg)
    model.load_state_dict(load_trained_params(cfg=cfg))
    return jcfg, jparams, model.eval()


def _images(seed, n, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, channels), dtype=np.uint8)


def _cosine(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


def test_feature_map_matches_jax(models):
    _, jparams, model = models
    imgs = _images(0, 2)
    want_f, want_g = JaxVGG16(compute_dtype=np.float32).apply({"params": jparams["vgg16"]}, imgs)
    with torch.no_grad():
        got_f, got_g = model.vgg16(torch.from_numpy(imgs))
    assert got_f.shape == (2, H // 16, W // 16, 512)  # NHWC, floor-pooled
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=FEATURE_ATOL, rtol=0)
    # the pre-normalization map: same check relative to its scale
    want_g = np.asarray(want_g)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g.numpy() / scale, want_g / scale, atol=FEATURE_ATOL, rtol=0)


def test_descriptor_matches_jax(models):
    jcfg, jparams, model = models
    imgs = _images(1, 3)
    want_out, want_full = create_model(jcfg).apply({"params": jparams}, imgs)
    with torch.no_grad():
        got_out, got_full = model(torch.from_numpy(imgs))
    assert got_full.shape == (3, 64 * 512)
    assert (_cosine(got_full.numpy(), np.asarray(want_full)) >= MIN_COSINE).all()
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)


def test_gray_input_is_promoted(models):
    jcfg, jparams, model = models
    gray = _images(2, 2, channels=1)
    want = create_model(jcfg).apply({"params": jparams}, gray)[1]
    with torch.no_grad():
        got = model(torch.from_numpy(gray))[1].numpy()
        rgb = model(torch.from_numpy(np.repeat(gray, 3, axis=-1)))[1].numpy()
    np.testing.assert_array_equal(got, rgb)
    assert (_cosine(got, np.asarray(want)) >= MIN_COSINE).all()


def test_odd_sizes_floor_like_jax():
    """180x240 pools 45 -> 22 (floor); checked on shapes alone at a small
    odd size with random weights."""
    cfg = ModelConfig(image_height=90, image_width=120, compute_dtype="float32", vlad_cores=4)
    with torch.no_grad():
        feats, _ = EmbeddingNet(cfg).vgg16(torch.zeros((1, 90, 120, 3), dtype=torch.uint8))
    assert feats.shape == (1, 5, 7, 512)  # 90->45->22->11->5, 120->60->30->15->7


def test_params_from_flax_mapping_and_checks():
    with np.load(TRAINED_PARAMS_PATH) as data:
        flat = {k: data[k] for k in data.files}
    state = params_from_flax(flat)
    assert len(state) == 29
    assert state["vgg16.block3.conv3_2.weight"].shape == (256, 256, 3, 3)
    np.testing.assert_array_equal(
        state["vgg16.block1.conv1_1.weight"].numpy(),
        flat["vgg16/block1/conv1_1/kernel"].astype(np.float32).transpose(3, 2, 0, 1))
    assert state["netvlad.assignment.weight"].shape == (64, 512, 1, 1)
    np.testing.assert_array_equal(  # negated sign kept, layout (D, K) kept
        state["netvlad.cluster_centers"].numpy(),
        flat["netvlad/cluster_centers"].astype(np.float32))
    assert all(t.dtype == torch.float32 for t in state.values())
    EmbeddingNet(ModelConfig()).load_state_dict(state)  # strict: every key used

    with pytest.raises(ValueError, match="missing"):
        params_from_flax({k: v for k, v in flat.items() if k != "vgg16/average_rgb"})
    with pytest.raises(ValueError, match="extra"):
        params_from_flax({**flat, "vgg16/extra": np.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_flax({**flat, "netvlad/cluster_centers": np.zeros((512, 32))})


def test_other_reductions_name_the_later_slice():
    """Every reduction and ``vlad_cores=0`` construct (the heads against
    JAX: ``tests/test_torch_heads.py``), and an unknown reduction raises."""
    for reduction in ("none", "1fc", "2fc", "3fc", "pca", "spp"):
        assert ModelConfig(reduction=reduction).reduction == reduction
    assert ModelConfig(vlad_cores=0).descriptor_dim == 11 * 15 * 512
    with pytest.raises(ValueError, match="unknown reduction"):
        ModelConfig(reduction="4fc")
