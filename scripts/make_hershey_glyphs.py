"""Write the glyph table that ``utils/cv.py::put_text`` draws its labels from.

The card's machine has no OpenCV, so the eval plots' labels are drawn from a
committed table of OpenCV's own pixels: for every printable ASCII character
(32-126) the coverage that ``cv2.putText`` draws for it alone with
``FONT_HERSHEY_SIMPLEX``, scale 1 and thickness 2 (the eval hooks' call;
OpenCV 5 antialiases the strokes whatever the line type), as the uint8
values it draws in white on black, with its offset from the text origin
and its integer advance (``cv2.getTextSize`` of one character less one:
the width of a string is the sum of its characters' advances plus one, and
character i of a string starts at the sum of the advances before it).
``cv2.putText`` of a string is its characters drawn one after the other,
each pixel under coverage a taking ``(v * (255 - a) + c * a + 127) // 255``
of its value v and the colour c; this script checks the table against
``cv2.putText`` on every label it writes a digest for.

``digests.json`` beside the table lists the SHA-256 of ``cv2.putText``'s
output for the eval hooks' labels ("Query", ``Retrieved {d:.1f}`` and
``Optimal {d:.1f}`` for seeded distances) on seeded uint8 canvases of
180x240, 240x180 and 960x1280 (height x width), so that a machine without
OpenCV can check the table. Run it where OpenCV is installed:

    python scripts/make_hershey_glyphs.py [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "soft_contrastive_learning_torch", "assets", "hershey")

FONT, SCALE, THICKNESS = cv2.FONT_HERSHEY_SIMPLEX, 1, 2
ORIGIN = (10, 35)  # put_text's
COLOR = (0, 255, 0)
CANVASES = ((180, 240), (240, 180), (960, 1280))


def glyph(ch: str):
    """The coverage of ``ch`` drawn alone, its top-left corner's offset from
    the origin (dx, dy) and its advance."""
    x0, y0 = 40, 70
    canvas = np.zeros((110, 110), np.uint8)
    cv2.putText(canvas, ch, (x0, y0), FONT, SCALE, 255, THICKNESS)
    ys, xs = np.nonzero(canvas)
    advance = cv2.getTextSize(ch, FONT, SCALE, THICKNESS)[0][0] - 1
    if len(ys) == 0:  # the space
        return np.zeros((0, 0), np.uint8), 0, 0, advance
    assert ys.min() > 0 and xs.min() > 0 and ys.max() < 109 and xs.max() < 109, ch
    cover = canvas[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1]
    return cover, int(xs.min()) - x0, int(ys.min()) - y0, advance


def labels():
    """The eval hooks' labels: "Query", and "Retrieved"/"Optimal" beside 60
    seeded distances (0.0 and values of 4 and 5 digits among them)."""
    rng = np.random.default_rng(17)
    dists = [0.0, 0.04, 0.05, 9.95, 1234.5, 98765.4] + list(rng.exponential(40.0, 54))
    out = ["Query"]
    for d in dists:
        out += [f"Retrieved {d:.1f}", f"Optimal {d:.1f}"]
    return out


def canvas(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    table = {}
    meta = np.zeros((95, 3), np.int32)  # dx, dy, advance per code - 32
    for code in range(32, 127):
        cover, dx, dy, advance = glyph(chr(code))
        table[f"g{code}"] = cover
        meta[code - 32] = (dx, dy, advance)
    np.savez_compressed(os.path.join(args.out, "glyphs.npz"), meta=meta, **table)

    sys.path.insert(0, ROOT)
    from soft_contrastive_learning_torch.utils import cv as port_cv

    port_cv._GLYPH_TABLE = os.path.join(args.out, "glyphs.npz")  # the table just written
    port_cv._glyphs.cache_clear()

    digests = []
    for i, text in enumerate(labels()):
        shape = CANVASES[i % len(CANVASES)]
        img = cv2.putText(canvas(shape, i), text, ORIGIN, FONT, SCALE, COLOR, THICKNESS)
        mine = port_cv.put_text(text, canvas(shape, i))
        if not np.array_equal(img, mine):
            raise SystemExit(f"the table does not draw {text!r} as cv2.putText does")
        digests.append({"text": text, "shape": list(img.shape), "seed": i,
                        "sha256": hashlib.sha256(img.tobytes()).hexdigest()})
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump({"opencv": cv2.__version__, "origin": list(ORIGIN), "color": list(COLOR),
                   "labels": digests}, f, indent=1)
    print(f"{len(table)} glyphs and {len(digests)} digests -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
