"""The port's INTER_LINEAR resize (``utils/cv.py::resize_linear``) against
``cv2.resize`` on the same seeded uint8 images: pixel for pixel, with no
pixel allowed to differ. The geometry helpers built on it against the JAX
package's, which call OpenCV."""

import cv2
import numpy as np
import pytest
import torch

from soft_contrastive_learning_torch.utils.cv import (
    merge_images,
    normalize_geometry,
    resize_linear,
    resize_to,
    standard_size,
)
from soft_contrastive_learning_tpu.utils import cv as jax_cv

CASES = [
    ((960, 1280, 3), 0.1875, 0.1875),  # a RobotCar frame to max side 240
    ((960, 1280), 0.1875, 0.1875),
    ((64, 96, 3), 0.5, 0.5),  # exactly 2x down: OpenCV's INTER_AREA
    ((65, 97, 3), 0.5, 0.5),  # ... with an odd edge
    ((37, 51), 0.5, 0.5),
    ((64, 96, 3), 0.5, 0.6),  # 2x on one axis only: linear
    ((60, 80, 3), 0.75, 0.75),
    ((61, 83, 3), 1.3, 1.3),
    ((33, 47, 4), 1.7, 0.9),
    ((90, 150, 3), 1.6, 1.6),
    ((101, 67, 3), 2.0, 2.0),
    ((100, 100, 3), 1.8, 1.8),
    ((59, 71, 3), 1 / 3, 1 / 3),
    ((17, 200), 0.26, 0.6),
    ((7, 5, 3), 3.1, 2.9),
    ((40, 60, 3), 1.0, 1.0),  # the same size: a copy
]


@pytest.mark.parametrize("shape,fx,fy", CASES)
def test_resize_linear_matches_cv2(shape, fx, fy):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, (0, 0), fx=fx, fy=fy)
    got = resize_linear(img, fx, fy)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [((61, 83, 3), (40, 57)), ((40, 30, 3), (80, 61)),
                                        ((33, 47), (12, 90)), ((64, 96, 3), (32, 48))])
def test_resize_to_matches_cv2(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(resize_to(img, *size), cv2.resize(img, size[::-1]))


def test_batched_tensor_matches_each_image():
    imgs = np.random.default_rng(1).integers(0, 256, (4, 60, 80, 3), dtype=np.uint8)
    got = resize_linear(torch.from_numpy(imgs), 0.75, 0.75)
    assert isinstance(got, torch.Tensor) and got.shape == (4, 45, 60, 3)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), cv2.resize(imgs[i], (0, 0), fx=0.75,
                                                                 fy=0.75))


@pytest.mark.parametrize("shape,keep_aspect,portrait", [
    ((90, 150, 3), True, False), ((100, 100, 3), False, False), ((240, 180, 3), False, True),
    ((481, 641, 3), True, False), ((45, 60, 3), False, False)])
def test_geometry_matches_jax(shape, keep_aspect, portrait):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        normalize_geometry(img, 180, 240, keep_aspect=keep_aspect, portrait=portrait),
        jax_cv.normalize_geometry(img, 180, 240, keep_aspect=keep_aspect, portrait=portrait))
    np.testing.assert_array_equal(standard_size(img, 48, 64), jax_cv.standard_size(img, 48, 64))


def test_merge_images_matches_jax():
    rng = np.random.default_rng(2)
    left = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    np.testing.assert_array_equal(merge_images(left, right), jax_cv.merge_images(left, right))


def test_resize_refuses_other_dtypes_and_empty_outputs():
    with pytest.raises(ValueError, match="uint8"):
        resize_linear(np.zeros((10, 10, 3), np.float32), 0.5, 0.5)
    with pytest.raises(ValueError, match="empty"):
        resize_linear(np.zeros((10, 10, 3), np.uint8), 0.01, 0.01)
