"""Image geometry that defines the network's input distribution.

Own copy of ``soft_contrastive_learning_tpu/utils/cv.py``
(``resize_img``, ``standard_size``, ``normalize_geometry``, and the eval
plots' ``put_text`` and ``merge_images``). JAX resizes with
``cv2.resize(INTER_LINEAR)``; the port resizes with ``resize_linear``, which
returns OpenCV's pixels (held equal to ``cv2.resize`` by
``tests/test_torch_cv_resize.py``) in integer arithmetic on any device, so
it needs no OpenCV. ``put_text`` draws OpenCV's pixels from a committed
glyph table (``assets/hershey/``, written by
``scripts/make_hershey_glyphs.py``), held equal to ``cv2.putText`` by
``tests/test_torch_put_text.py``, so it needs no OpenCV either.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

# OpenCV's fixed point for INTER_LINEAR on 8-bit images: 11-bit coefficients
# (INTER_RESIZE_COEF_BITS), so a two-pass sum carries 22 fractional bits
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_DBL_EPSILON = float(np.finfo(np.float64).eps)


# put_text's table: per printable ASCII character, the coverage cv2.putText
# draws for it alone (FONT_HERSHEY_SIMPLEX, scale 1, thickness 2; OpenCV 5
# antialiases), its offset from the text origin and the character's advance
_GLYPH_TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "hershey", "glyphs.npz")
_TEXT_ORIGIN = (10, 35)


@functools.lru_cache(maxsize=1)
def _glyphs() -> Dict[int, Tuple[np.ndarray, int, int, int]]:
    glyphs = {}
    with np.load(_GLYPH_TABLE) as z:
        for code in range(32, 127):
            cover = z[f"g{code}"]
            cover.flags.writeable = False  # shared by every call
            glyphs[code] = (cover, *map(int, z["meta"][code - 32]))
    return glyphs


def _taps(n_in: int, n_out: int, scale: float, device, columns: bool
          ) -> Tuple[torch.Tensor, ...]:
    """One axis's source index pair and 11-bit weights, as OpenCV's
    ``resize`` builds them: the source coordinate ``(d + 0.5) * scale - 0.5``
    in double, cast to float; its floor and fraction in float; the weights
    ``1 - f`` and ``f`` times 2048, each rounded half to even; the indices
    clamped to the image. For ``columns`` a clamped index also gets the
    fraction 0; the rows keep theirs (both weights then fall on one row,
    and the vertical pass rounds each product apart)."""
    d = np.arange(n_out, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if columns:
        f[(s < 0) | (s >= n_in - 1)] = 0
    s0, s1 = np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return as_t(s0), as_t(s1), as_t(w0), as_t(w1)


def _resize_area2(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """OpenCV's INTER_AREA at an exact 2x downscale on (B, H, W, C) int32:
    a 2x2 block's mean ``(sum + 2) >> 2``; a block cut by an odd edge, the
    float mean of its pixels rounded half to even."""
    b, h, w, c = x.shape
    full = torch.zeros((b, 2 * oh, 2 * ow, c), dtype=torch.int32, device=x.device)
    count = torch.zeros((2 * oh, 2 * ow), dtype=torch.int32, device=x.device)
    hh, ww = min(h, 2 * oh), min(w, 2 * ow)
    full[:, :hh, :ww] = x[:, :hh, :ww]
    count[:hh, :ww] = 1
    s = full.reshape(b, oh, 2, ow, 2, c).sum((2, 4), dtype=torch.int32)
    n = count.reshape(oh, 2, ow, 2).sum((1, 3), dtype=torch.int32)[None, :, :, None]
    part = torch.round(s.float() / n.float()).to(torch.int32)
    return torch.where(n == 4, (s + 2) >> 2, part)


def _as_batch(img, device):
    """(tensor (B, H, W, C) on ``device``, how to give the result back)."""
    as_numpy = isinstance(img, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    if x.dtype != torch.uint8:
        raise ValueError(f"the resize takes uint8 images (OpenCV's fixed-point INTER_LINEAR); "
                         f"got {x.dtype}")
    if x.ndim not in (2, 3, 4):
        raise ValueError(f"the resize takes (H, W), (H, W, C) or (B, H, W, C); got shape "
                         f"{tuple(x.shape)}")
    lead, tail = (1,) * (4 - max(x.ndim, 3)), (1,) * (x.ndim == 2)
    x4 = x.to(device if device is not None else x.device).reshape(lead + tuple(x.shape) + tail)

    def back(out: torch.Tensor):
        out = out.reshape(out.shape[:3] if x.ndim == 2 else out.shape)
        out = out[0] if x.ndim < 4 else out
        return out.cpu().numpy() if as_numpy else out

    return x4, back


def _resize(x: torch.Tensor, oh: int, ow: int, inv_fx: float, inv_fy: float) -> torch.Tensor:
    """OpenCV's ``resize`` INTER_LINEAR of (B, H, W, C) uint8 to (oh, ow),
    the source map stepping by ``1 / inv_f`` (OpenCV's ``inv_scale``)."""
    h, w = x.shape[1], x.shape[2]
    if oh <= 0 or ow <= 0:
        raise ValueError(f"resize of {h}x{w} to an empty {oh}x{ow} image")
    if (oh, ow) == (h, w):
        return x.clone()
    sx, sy = 1.0 / inv_fx, 1.0 / inv_fy
    xi = x.to(torch.int32)
    if (abs(sx - round(sx)) < _DBL_EPSILON and abs(sy - round(sy)) < _DBL_EPSILON
            and round(sx) == 2 and round(sy) == 2):
        out = _resize_area2(xi, oh, ow)
    else:
        r0, r1, b0, b1 = _taps(h, oh, sy, x.device, columns=False)
        c0, c1, a0, a1 = _taps(w, ow, sx, x.device, columns=True)
        a0, a1 = a0[:, None], a1[:, None]

        def vterm(rows, b):  # a row of the horizontal pass, OpenCV's SIMD half
            return ((rows[:, :, c0] * a0 + rows[:, :, c1] * a1) >> 4) * b[:, None, None] >> 16

        out = (vterm(xi[:, r0], b0) + vterm(xi[:, r1], b1) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def resize_linear(img, fx: float, fy: float, device=None):
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy)`` (INTER_LINEAR) on uint8
    images, pixel for pixel, in integer arithmetic on ``device``.

    ``img``: (H, W), (H, W, C) or (B, H, W, C) uint8, numpy or a tensor; a
    numpy image comes back as numpy (computed on ``device``, default the
    CPU), a tensor on ``device`` (default its own). What OpenCV runs:

    * the output size ``round(H * fy), round(W * fx)`` (half to even), and
      the source map steps by ``1 / fx`` (not the ratio of the sizes);
    * an output of the input's size is a copy;
    * a scale of exactly 2 on both axes (``1 / f`` within DBL_EPSILON of 2)
      switches to INTER_AREA (``_resize_area2``);
    * otherwise each output pixel takes two source columns with 11-bit
      weights (``_taps``) into an int32 row, then two of those rows with
      11-bit weights through OpenCV's SIMD vertical pass,
      ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2``, which
      rounds differently from the scalar ``(r0 b0 + r1 b1 + 2^21) >> 22``;
      ``cv2.resize`` returns the SIMD pass's value at every column.
    """
    x, back = _as_batch(img, device)
    oh, ow = int(round(x.shape[1] * fy)), int(round(x.shape[2] * fx))
    return back(_resize(x, oh, ow, fx, fy))


def resize_to(img, h: int, w: int, device=None):
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR): ``resize_linear`` at a
    given size, the scales the sizes' ratios."""
    x, back = _as_batch(img, device)
    return back(_resize(x, h, w, w / x.shape[2], h / x.shape[1]))


def resize_img(img: np.ndarray, max_size: int) -> np.ndarray:
    """Aspect-preserving resize so max(h, w) == max_size."""
    scale = max_size / float(max(img.shape[0], img.shape[1]))
    return resize_linear(img, scale, scale)


def standard_size(img: np.ndarray, h: int = 180, w: int = 240) -> np.ndarray:
    """Scale to cover (h, w), then center-crop to exactly (h, w)."""
    ih, iw = img.shape[0], img.shape[1]
    scale = max(h / ih, w / iw)
    img = resize_linear(img, scale, scale)
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
    """Overlay a label in the top-left corner of an (H, W, 3) uint8 image,
    in place, and return the image: JAX's ``cv2.putText(image, text, (10,
    35), FONT_HERSHEY_SIMPLEX, scale, color, 2)``, drawn from the glyph
    table. The characters are drawn
    one after the other, character i at the origin plus the advances of the
    characters before it, clipped to the image: a pixel under coverage a
    becomes ``(v * (255 - a) + c * a + 127) // 255`` of its value v and the
    colour c, as OpenCV blends. The table holds scale 1 and printable ASCII
    only: anything else raises ``ValueError``."""
    if scale != 1:
        raise ValueError(f"put_text draws at scale 1 only (the glyph table's), not {scale}")
    bad = sorted({ch for ch in text if not 32 <= ord(ch) <= 126})
    if bad:
        raise ValueError(f"put_text draws printable ASCII only, not {bad}")
    value = np.asarray(color, dtype=np.int32)
    h, w = image.shape[:2]
    x = _TEXT_ORIGIN[0]
    for ch in text:
        cover, dx, dy, advance = _glyphs()[ord(ch)]
        top, left = _TEXT_ORIGIN[1] + dy, x + dx
        y0, y1 = max(top, 0), min(top + cover.shape[0], h)
        x0, x1 = max(left, 0), min(left + cover.shape[1], w)
        if y1 > y0 and x1 > x0:
            a = cover[y0 - top : y1 - top, x0 - left : x1 - left, None].astype(np.int32)
            region = image[y0:y1, x0:x1]
            region[...] = (region.astype(np.int32) * (255 - a) + value * a + 127) // 255
        x += advance
    return image


def merge_images(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Side-by-side merge, the right image rescaled to the left's height
    (``cv2.resize`` to that size: the scales are the sizes' ratios)."""
    nw = right.shape[1] * left.shape[0] // right.shape[0]
    right = resize_to(right, left.shape[0], nw)
    return np.concatenate((left, right), axis=1)
