"""The port's ``run_inference`` and ``DescriptorExtractor`` against the JAX
package's, on the CPU: the same PNG files (written by the port's writer),
the same CSV list and the same weights (the JAX init through
``params_from_flax``) give the same dump, a small fp32 model (NetVLAD-4 at
32x40), batch 8 over 37 images (the last batch padded). Tolerance: 1e-5
absolute on unit-norm descriptors (the frameworks sum in other orders);
float16 dumps are the float32 dump rounded, exactly for the port's own and
within one float16 step (1e-3) of JAX's. Covered too: ``achen`` sets run
portrait, ``oxs`` sets read ``.jpg`` and the port's decoder refuses JPEG,
naming it; a dump dtype other than float32/float16 is refused."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from soft_contrastive_learning_torch.core.config import ModelConfig
from soft_contrastive_learning_torch.data.toycity import ToyCity
from soft_contrastive_learning_torch.evaluation.inference import (
    DescriptorExtractor,
    run_inference,
)
from soft_contrastive_learning_torch.models.weights import params_from_flax
from soft_contrastive_learning_torch.utils.io import load_img, load_pickle, save_csv, save_img
from soft_contrastive_learning_tpu.core import config as jcfg
from soft_contrastive_learning_tpu.evaluation import inference as jinference
from soft_contrastive_learning_tpu.models.model import init_params as jax_init_params

torch.set_num_threads(1)  # tier-1 runs several workers on one host

H, W, N, BATCH = 32, 40, 37, 8


@pytest.fixture(scope="module")
def models():
    jax_cfg = jcfg.ModelConfig(vlad_cores=4, image_height=H, image_width=W,
                               compute_dtype="float32", use_pallas=False)
    jax_params = jax_init_params(jax_cfg, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(jax_params), sep="/").items()}
    cfg = ModelConfig(vlad_cores=4, image_height=H, image_width=W, compute_dtype="float32")
    return cfg, params_from_flax(flat, cfg), jax_cfg, jax_params


def _write_set(root, name, h=H, w=W, ext=".png"):
    """N toy-city views as image files and ``lists/{name}.csv`` naming them
    ``.png`` (the oxs convention: the files themselves may be ``.jpg``)."""
    city = ToyCity(num_points=N, radius=8.0, img_h=h, img_w=w, seed=4)
    os.makedirs(os.path.join(root, "imgs", name), exist_ok=True)
    rel = []
    for i in range(N):
        rel.append(f"{name}/{i:04d}.png")
        path = os.path.join(root, "imgs", rel[-1])
        if ext == ".png":
            save_img(city.image(i), path)
        else:
            cv2.imwrite(path.replace(".png", ext), city.image(i)[:, :, ::-1])
    os.makedirs(os.path.join(root, "lists"), exist_ok=True)
    save_csv({"path": rel, "easting": list(city.easting), "northing": list(city.northing)},
             os.path.join(root, "lists", f"{name}.csv"))
    return [os.path.join(root, "imgs", p) for p in rel]


def _run_both(models, root, name, **kw):
    cfg, params, jax_cfg, jax_params = models
    args = (name, os.path.join(root, "lists"), os.path.join(root, "imgs"))
    got = run_inference(cfg, params, *args, os.path.join(root, "lv_port"), "m",
                        batch_size=BATCH, device="cpu", **kw)
    want = jinference.run_inference(jax_cfg, jax_params, *args, os.path.join(root, "lv_jax"),
                                    "m", batch_size=BATCH, **kw)
    return got, want


@pytest.mark.parametrize("name", ["toy_ref", "achen_night"])
def test_run_inference_equals_jax(models, tmp_path, name):
    portrait = "achen" in name
    paths = _write_set(str(tmp_path), name, *((W, H) if portrait else (H, W)))
    got, want = _run_both(models, str(tmp_path), name)
    assert os.path.basename(got) == os.path.basename(want) == f"{name}_m.pickle"
    feats, jfeats = load_pickle(got), np.asarray(load_pickle(want))
    assert feats.dtype == np.float32 and feats.shape == (N, 4 * 512) == jfeats.shape
    np.testing.assert_allclose(feats, jfeats, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
    # the padded last batch (37 = 4 x 8 + 5) changes no row: each image alone
    extractor = DescriptorExtractor(models[0], models[1], batch_size=BATCH, device="cpu",
                                    portrait=portrait)
    alone = extractor.extract_images([load_img(paths[-1])])
    np.testing.assert_allclose(alone[0], feats[-1], atol=1e-6, rtol=0)


def test_float16_dumps(models, tmp_path):
    _write_set(str(tmp_path), "toy_query")
    got32, _ = _run_both(models, str(tmp_path), "toy_query")
    f32 = load_pickle(got32)
    cfg, params, jax_cfg, jax_params = models
    args = ("toy_query", str(tmp_path / "lists"), str(tmp_path / "imgs"))
    got = load_pickle(run_inference(cfg, params, *args, str(tmp_path / "lv16"), "m",
                                    batch_size=BATCH, device="cpu", dump_dtype="float16"))
    want = np.asarray(load_pickle(jinference.run_inference(
        jax_cfg, jax_params, *args, str(tmp_path / "lv16_jax"), "m", batch_size=BATCH,
        dump_dtype="float16")))
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_array_equal(got, f32.astype(np.float16))
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-3)
    with pytest.raises(ValueError, match="dump_dtype"):
        run_inference(cfg, params, *args, str(tmp_path / "bad"), "m", device="cpu",
                      dump_dtype="bfloat16")


def test_oxs_sets_read_jpg_which_the_port_refuses(models, tmp_path):
    """JAX reads an oxs set's ``.jpg`` files through OpenCV; the port looks
    for the same ``.jpg`` paths and its decoder refuses JPEG, saying so."""
    _write_set(str(tmp_path), "oxs_test", ext=".jpg")
    cfg, params, jax_cfg, jax_params = models
    args = ("oxs_test", str(tmp_path / "lists"), str(tmp_path / "imgs"))
    jax_out = jinference.run_inference(jax_cfg, jax_params, *args, str(tmp_path / "lv"), "m",
                                       batch_size=BATCH)
    assert np.asarray(load_pickle(jax_out)).shape == (N, 4 * 512)
    with pytest.raises(ValueError, match=r"oxs_test/0000\.jpg: a JPEG file"):
        run_inference(cfg, params, *args, str(tmp_path / "lv_port"), "m", batch_size=BATCH,
                      device="cpu")


def test_extract_files_of_no_paths_and_the_raw_flag(models):
    cfg, params, _, _ = models
    extractor = DescriptorExtractor(cfg, params, batch_size=4, device="cpu",
                                    raw_descriptor=False)
    out = extractor.extract_files([])
    assert out.shape == (0, cfg.output_dim) and out.dtype == np.float32
