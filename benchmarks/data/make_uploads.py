"""Writes the search cells' uploads: ``uploads/q_XX.jpg`` (the queries that
the traffic sends), ``uploads/db_XX.jpg`` (views of the same places from
nearby positions, embedded into the index at set-up) and
``query_pixels.npz`` (each query's pixels as ``cv2.imdecode`` gives them,
RGB, which the plain reference reads in place of a JPEG decoder).

Each place is a photo-like canvas: a 1/f colour field (the amplitude
spectrum of natural images), a sky-to-ground gradient and a few flat
façades with sharp edges; a view is a 180x240 crop of it. Encoded as
JPEG at quality 95 with 4:2:0 chroma. Needs OpenCV; run once from the
repository root::

    python benchmarks/data/make_uploads.py
"""

from __future__ import annotations

import os

import cv2
import numpy as np

PLACES = 48
H, W = 180, 240
CANVAS = (228, 300)
HERE = os.path.dirname(os.path.abspath(__file__))


def pink_field(rng: np.random.Generator, shape) -> np.ndarray:
    h, w = shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    out = []
    for _ in range(3):
        spec = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))) / f
        spec[0, 0] = 0.0
        field = np.real(np.fft.ifft2(spec))
        out.append(field / field.std())
    mix = rng.normal(size=(3, 3)) * 0.35 + np.eye(3)  # correlated colour channels
    return np.einsum("chw,cd->hwd", np.stack(out), mix)


def canvas(rng: np.random.Generator) -> np.ndarray:
    h, w = CANVAS
    img = 118.0 + 30.0 * pink_field(rng, (h, w))
    horizon = int(rng.integers(h // 4, h // 2))
    sky = np.array(rng.uniform(150, 230, 3))
    img[:horizon] = 0.55 * img[:horizon] + 0.45 * sky
    for _ in range(int(rng.integers(3, 7))):  # façades: flat colour, sharp edges, windows
        x0 = int(rng.integers(0, w - 40))
        x1 = min(w, x0 + int(rng.integers(30, 110)))
        y0 = int(rng.integers(horizon // 2, horizon + 20))
        colour = rng.uniform(40, 220, 3)
        img[y0:, x0:x1] = 0.25 * img[y0:, x0:x1] + 0.75 * colour
        for wy in range(y0 + 6, h - 10, 18):
            for wx in range(x0 + 4, x1 - 8, 14):
                img[wy : wy + 9, wx : wx + 7] = rng.uniform(10, 80)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(rgb: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    assert ok
    return buf.tobytes()


def main() -> None:
    rng = np.random.default_rng(2020_12_06)
    pixels = []
    sizes = []
    for p in range(PLACES):
        c = canvas(rng)
        y, x = int(rng.integers(12, CANVAS[0] - H - 11)), int(rng.integers(12, CANVAS[1] - W - 11))
        dy, dx = (int(v) for v in rng.integers(-12, 13, 2))
        views = {"q": c[y : y + H, x : x + W], "db": c[y + dy : y + dy + H, x + dx : x + dx + W]}
        for kind, view in views.items():
            data = encode(view)
            sizes.append(len(data))
            with open(os.path.join(HERE, "uploads", f"{kind}_{p:02d}.jpg"), "wb") as f:
                f.write(data)
            if kind == "q":
                decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
                pixels.append(decoded[:, :, ::-1])
    np.savez_compressed(os.path.join(HERE, "query_pixels.npz"), pixels=np.stack(pixels))
    print(f"{len(sizes)} JPEGs, {min(sizes)}-{max(sizes)} bytes, mean {np.mean(sizes):.0f}")


if __name__ == "__main__":
    main()
