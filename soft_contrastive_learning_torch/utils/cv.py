"""Image geometry that defines the network's input distribution.

Own copy of ``soft_contrastive_learning_tpu/utils/cv.py``
(``resize_img``, ``standard_size``, ``normalize_geometry``, and the eval
plots' ``put_text`` and ``merge_images``). OpenCV is imported only when an
image actually needs resizing or drawing; where it is missing, that raises
rather than passing an image of the wrong size on.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "resizing or drawing on an image needs OpenCV (cv2), which is not "
            "installed; pass images already at the model's (height, width)") from e
    return cv2


def resize_img(img: np.ndarray, max_size: int) -> np.ndarray:
    """Aspect-preserving resize so max(h, w) == max_size."""
    scale = max_size / float(max(img.shape[0], img.shape[1]))
    return _cv2().resize(img, (0, 0), fx=scale, fy=scale)


def standard_size(img: np.ndarray, h: int = 180, w: int = 240) -> np.ndarray:
    """Scale to cover (h, w), then center-crop to exactly (h, w)."""
    ih, iw = img.shape[0], img.shape[1]
    scale = max(h / ih, w / iw)
    img = _cv2().resize(img, (0, 0), fx=scale, fy=scale)
    nh, nw = img.shape[0], img.shape[1]
    top = math.floor((nh - h) / 2.0)
    left = math.floor((nw - w) / 2.0)
    return img[top : top + h, left : left + w, :]


def normalize_geometry(
    img: np.ndarray,
    h: int,
    w: int,
    keep_aspect: bool = False,
    portrait: bool = False,
) -> np.ndarray:
    """Bring an image to the network's (h, w): NetVLAD-style models keep
    aspect via a max-side resize first; ``portrait`` swaps the target dims."""
    if portrait:
        h, w = max(h, w), min(h, w)
    if keep_aspect and not portrait and (img.shape[0], img.shape[1]) != (h, w):
        img = resize_img(img, max(h, w))
    if (img.shape[0], img.shape[1]) != (h, w):
        img = standard_size(img, h=h, w=w)
    return img


def put_text(text: str, image: np.ndarray, scale: float = 1,
             color: Tuple[int, int, int] = (0, 255, 0)) -> np.ndarray:
    """Overlay a label in the top-left corner."""
    cv2 = _cv2()
    return cv2.putText(image, text, (10, 35), cv2.FONT_HERSHEY_SIMPLEX, scale, color, 2)


def merge_images(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Side-by-side merge, the right image rescaled to the left's height."""
    right = _cv2().resize(
        right, (right.shape[1] * left.shape[0] // right.shape[0], left.shape[0]))
    return np.concatenate((left, right), axis=1)
