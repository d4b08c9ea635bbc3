"""Write the JPEG fixtures the port's decoder is held to on the card.

The card's machine has no OpenCV or PIL, so the fixtures carry their own
answers: each file under ``soft_contrastive_learning_torch/assets/jpeg/`` is
listed in ``digests.json`` with the SHA-256 of the (H, W, 3) uint8 RGB array
(C order) that ``cv2.imread`` then BGR -> RGB gives on the machine that ran
this script, and its shape; the files that the port refuses are listed with
the words their reason must hold. Run it where OpenCV and PIL are installed:

    python scripts/make_jpeg_fixtures.py [--out DIR]

The images are toy-city views with seeded noise (texture for the AC
coefficients), at 180x240 unless named otherwise: 4:2:0 at quality 95
(OpenCV's default), 4:4:4, 4:2:2, 4:4:0, 4:1:1, gray, progressive (PIL and
OpenCV), restart interval 3, 181x243, EXIF orientations 2-8, an Adobe RGB
file, and one 1280x960 frame (RobotCar's size) at quality 90.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from soft_contrastive_learning_torch.data.toycity import ToyCity  # noqa: E402

OUT = os.path.join(ROOT, "soft_contrastive_learning_torch", "assets", "jpeg")


def view(h: int, w: int, index: int, seed: int) -> np.ndarray:
    city = ToyCity(num_points=16, radius=40.0, img_h=h, img_w=w, seed=seed)
    noise = np.random.default_rng(seed).integers(-12, 13, (h, w, 3))
    return np.clip(city.image(index).astype(int) + noise, 0, 255).astype(np.uint8)


def cv2_jpeg(rgb: np.ndarray, *params: int) -> bytes:
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]) if rgb.ndim == 3 else rgb,
                           list(params))
    assert ok
    return buf.tobytes()


def pil_jpeg(rgb: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **kw)
    return buf.getvalue()


def exif(orientation: int) -> bytes:
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def fixtures():
    S = cv2
    img = view(180, 240, 3, 7)
    files = {
        "c420_q95.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_QUALITY, 95),
        "c444.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_SAMPLING_FACTOR,
                             S.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "c422.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_SAMPLING_FACTOR,
                             S.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "c440.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_SAMPLING_FACTOR,
                             S.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "c411.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_SAMPLING_FACTOR,
                             S.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "gray.jpg": cv2_jpeg(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), S.IMWRITE_JPEG_QUALITY, 90),
        "progressive_pil.jpg": pil_jpeg(img, quality=90, progressive=True),
        "progressive_cv2.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_PROGRESSIVE, 1),
        "restart3.jpg": cv2_jpeg(img, S.IMWRITE_JPEG_RST_INTERVAL, 3),
        "odd_181x243.jpg": cv2_jpeg(view(181, 243, 5, 8), S.IMWRITE_JPEG_QUALITY, 95),
        "adobe_rgb.jpg": pil_jpeg(img, quality=90, keep_rgb=True),
        "frame_1280x960.jpg": cv2_jpeg(view(960, 1280, 2, 9), S.IMWRITE_JPEG_QUALITY, 90),
    }
    for o in range(2, 9):
        files[f"orient{o}.jpg"] = pil_jpeg(img, quality=90, exif=exif(o))
    base = bytearray(cv2_jpeg(view(16, 24, 1, 3)))
    sof = base.find(b"\xff\xc0")

    def patched(at: int, value: int) -> bytes:
        out = bytearray(base)
        out[at] = value
        return bytes(out)

    refused = {
        "refused_truncated.jpg": (files["c420_q95.jpg"][: len(files["c420_q95.jpg"]) // 2],
                                  "truncated"),
        "refused_arithmetic.jpg": (patched(sof + 1, 0xC9), "arithmetic-coded"),
        "refused_lossless.jpg": (patched(sof + 1, 0xC3), "lossless"),
        "refused_12bit.jpg": (patched(sof + 4, 12), "12-bit"),
        "refused_cmyk.jpg": (_cmyk(view(16, 24, 1, 3)), "CMYK"),
    }
    return files, refused


def _cmyk(rgb: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    files, refused = fixtures()
    table = {"decoded": {}, "refused": {}, "opencv": cv2.__version__}
    for name, data in files.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        rgb = np.ascontiguousarray(cv2.imread(os.path.join(args.out, name))[..., ::-1])
        table["decoded"][name] = {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                                  "shape": list(rgb.shape)}
    for name, (data, reason) in refused.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table["refused"][name] = reason
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in os.listdir(args.out))
    print(f"{len(files)} decoded and {len(refused)} refused fixtures, {total / 1e6:.3f} MB "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
