"""Cross-check the port's JPEG decoders against OpenCV on a host with OpenCV,
PIL and g++ (no card needed):

    python scripts/jpeg_crosscheck.py [--fuzz 300]

1. OpenCV and PIL write JPEGs of every layout the port decodes (4:2:0,
   4:4:4, 4:2:2, 4:4:0, 4:1:1, gray; baseline, progressive, restart
   intervals; qualities 5-100; sizes 1x1 to 181x243; PIL's own progressive
   scans and Adobe RGB; EXIF orientations 1-8), and the plain path
   (``utils/jpeg.py``) must decode each to ``cv2.imdecode``'s pixels.
2. ``ops/kernels/csrc/jpeg.cu`` is built with g++ (its kernels are under
   ``__CUDACC__``; their per-thread functions are ``__host__ __device__``),
   and on every file of (1) its entropy decoder must give the plain
   decoder's coefficients and tables, and a host loop over J1's two
   launches' per-thread functions the plain pixel stage's image.
3. Truncations and single-byte changes of three files (baseline,
   progressive, restart intervals): both entropy decoders must refuse, or
   give the same coefficients.

It prints one line per part and exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from soft_contrastive_learning_torch.ops.kernels.jpeg import _geometry  # noqa: E402
from soft_contrastive_learning_torch.utils import jpeg  # noqa: E402

# the host loop over J1's two launches: every block's column and row passes,
# then every output pixel, through the kernels' own per-thread functions
HARNESS = r"""
#include "%s"
extern "C" int j1_on_host(const int16_t* coefs, const int32_t* quant, uint8_t* planes,
                          uint8_t* out, const int64_t* comp, int ncomp, int colour,
                          int orientation, int height, int width, int64_t blocks) {
  J1Geom g;
  memset(&g, 0, sizeof g);
  g.ncomp = ncomp; g.colour = colour; g.orientation = orientation;
  g.height = height; g.width = width; g.blocks = blocks;
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* k = comp + 9 * c;
    g.c[c] = J1Comp{k[0], k[1], (int)k[2], (int)k[3], (int)k[4], (int)k[5], (int)k[6],
                    (int)k[7], (int)k[8]};
  }
  for (int64_t blk = 0; blk < blocks; ++blk) {
    long long ws[64];
    const int ci = find_comp(g, blk);
    for (int lane = 0; lane < 8; ++lane) idct_column(coefs + blk * 64, quant + ci * 64, lane, ws);
    const J1Comp& k = g.c[ci];
    const int64_t b = blk - k.block0;
    const int by = (int)(b / k.bw), bx = (int)(b %% k.bw);
    for (int lane = 0; lane < 8; ++lane)
      idct_row(ws, lane, planes + k.plane0 + (int64_t)(by * 8 + lane) * (k.bw * 8) + bx * 8);
  }
  const int out_w = orientation >= 5 ? height : width;
  for (int64_t i = 0; i < (int64_t)height * width; ++i)
    pixel(planes, g, (int)(i / out_w), (int)(i %% out_w), out + i * 3);
  return 0;
}
"""


def textured(rng, h, w):
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 3 + y) % 256, (y * 5) % 256, ((x - y) * 2) % 256], -1)
    return np.clip(base + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def files():
    """(name, bytes) of the sweep of part 1."""
    rng = np.random.default_rng(1)
    out = []
    sampling = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]
    for h, w in [(180, 240), (181, 243), (17, 9), (8, 8), (1, 1), (2, 3), (33, 3)]:
        rgb = textured(rng, h, w)
        bgr = np.ascontiguousarray(rgb[..., ::-1])
        for samp in sampling:
            for q in (95, 50, 5, 100):
                for extra in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                              [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]):
                    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              samp, *extra]
                    out.append((f"{h}x{w} {samp:#x} q{q} {extra}",
                                cv2.imencode(".jpg", bgr, params)[1].tobytes()))
        gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        out.append((f"{h}x{w} gray", cv2.imencode(".jpg", gray)[1].tobytes()))
        for mode, kw in (("RGB", {"subsampling": 0}), ("RGB", {"subsampling": 1}),
                         ("RGB", {"subsampling": 2}), ("L", {}), ("RGB", {"keep_rgb": True})):
            for prog in (False, True):
                buf = io.BytesIO()
                Image.fromarray(rgb).convert(mode).save(buf, "JPEG", quality=90,
                                                        progressive=prog, **kw)
                out.append((f"{h}x{w} PIL {mode} {kw} prog{prog}", buf.getvalue()))
    for o in range(1, 9):
        ex = Image.Exif()
        ex[0x0112] = o
        buf = io.BytesIO()
        Image.fromarray(textured(rng, 20, 30)).save(buf, "JPEG", quality=95, exif=ex.tobytes())
        out.append((f"orientation {o}", buf.getvalue()))
    return out


def build(tmp):
    src = os.path.join(tmp, "j1_host.cpp")
    with open(src, "w") as f:
        f.write(HARNESS % os.path.join(ROOT, "soft_contrastive_learning_torch", "ops", "kernels",
                                       "csrc", "jpeg.cu"))
    lib = os.path.join(tmp, "libj1_host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-o", lib, src],
                   check=True)
    dll = ctypes.CDLL(lib)
    p = ctypes.c_void_p
    dll.scl_jpeg_info.argtypes = [p, ctypes.c_int64, p, p, ctypes.c_int]
    dll.scl_jpeg_entropy.argtypes = [p, ctypes.c_int64, p, p, p, p, ctypes.c_int]
    dll.j1_on_host.argtypes = [p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64]
    return dll


def native(dll, data):
    """``ops/kernels/jpeg.py::entropy_decode`` on the g++ build."""
    import soft_contrastive_learning_torch.ops.kernels.jpeg as kj

    real = kj._lib
    kj._lib = lambda: dll
    try:
        return kj.entropy_decode(data, "f")
    finally:
        kj._lib = real


def j1_on_host(dll, co):
    f = co.frame
    geom = _geometry(f)
    planes = np.zeros(f.block_offsets()[-1] * 64, np.uint8)
    out = np.zeros((*f.output_shape(), 3), np.uint8)
    dll.j1_on_host(co.coefs.ctypes.data, co.quant.ctypes.data, planes.ctypes.data,
                   out.ctypes.data, geom.ctypes.data, len(f.components), f.colour,
                   f.orientation, f.height, f.width, f.block_offsets()[-1])
    return out


def outcome(fn, data):
    try:
        co = fn(data)
        return "ok", co.coefs.tobytes() + co.quant.tobytes()
    except ValueError as e:
        return "refused", str(e)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fuzz", type=int, default=300, help="byte changes per file in part 3")
    args = p.parse_args(argv)
    bad = 0
    sweep = files()
    for name, data in sweep:
        want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        co = jpeg.decode_coefficients(data, name)
        got = jpeg.pixels_plain(torch.from_numpy(co.coefs), torch.from_numpy(co.quant),
                                co.frame).numpy()
        if got.shape != want.shape or (got != want).any():
            bad += 1
            print(f"plain decode differs from OpenCV: {name}")
    print(f"1. {len(sweep)} OpenCV/PIL files: {len(sweep) - bad} decoded to OpenCV's pixels")
    with tempfile.TemporaryDirectory() as tmp:
        dll = build(tmp)
        wrong = 0
        for name, data in sweep:
            co, ref = native(dll, data), jpeg.decode_coefficients(data, name)
            same = (np.array_equal(co.coefs, ref.coefs) and np.array_equal(co.quant, ref.quant)
                    and co.frame == ref.frame)
            plain = jpeg.pixels_plain(torch.from_numpy(ref.coefs), torch.from_numpy(ref.quant),
                                      ref.frame).numpy()
            if not same or not np.array_equal(j1_on_host(dll, co), plain):
                wrong += 1
                print(f"compiled decoder or J1's functions differ: {name}")
        print(f"2. the same files: the g++-built entropy decoder and J1's per-thread functions "
              f"equal the plain ones on {len(sweep) - wrong}")
        bad += wrong
        rng = np.random.default_rng(5)
        im = rng.integers(0, 255, (40, 56, 3), np.uint8)
        seeds = [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 80, *extra])[1].tobytes()
                 for extra in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                               [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])]
        cases = []
        for s in seeds:
            cases += [s[:cut] for cut in range(0, len(s), 7)]
            for _ in range(args.fuzz):
                d = bytearray(s)
                d[rng.integers(2, len(d))] = rng.integers(0, 256)
                cases.append(bytes(d))
        counts = {"refused": 0, "ok": 0}
        differ = 0
        for d in cases:
            a = outcome(lambda x: jpeg.decode_coefficients(x, "f"), d)
            b = outcome(lambda x: native(dll, x), d)
            if a[0] != b[0] or (a[0] == "ok" and a[1] != b[1]):
                differ += 1
                print(f"decoders differ: {a[0]} / {b[0]}: {a[1][:160] if a[0] == 'refused' else ''} "
                      f"| {b[1][:160] if b[0] == 'refused' else ''}")
            else:
                counts[a[0]] += 1
        print(f"3. {len(cases)} truncated or changed files: both decoders refused "
              f"{counts['refused']}, both gave the same coefficients for {counts['ok']}, "
              f"{differ} differ")
        bad += differ
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
