"""Cross-check the port's JPEG decoders against OpenCV on a host with OpenCV,
PIL and g++ (no card needed):

    python scripts/jpeg_crosscheck.py [--fuzz 300]

Every comparison is made in both of OpenCV's modes: ``file`` (cv2.imread,
``load_img``) and ``buffer`` (cv2.imdecode, ``decode_img``). "Exact" means
the port decodes where OpenCV does, refuses where it gives no image, and
gives its pixels wherever the IDCT stays in libjpeg-turbo's 16-bit SIMD
lanes (``utils/jpeg.py::idct_in_16_bit_lanes``; outside them the port
computes exactly, a recorded divergence, counted apart).

1. OpenCV and PIL write JPEGs of every layout the port decodes (4:2:0,
   4:4:4, 4:2:2, 4:4:0, 4:1:1, gray; baseline, progressive, restart
   intervals; qualities 5-100; sizes 1x1 to 181x243; PIL's own progressive
   scans, Adobe RGB and CMYK at three samplings, with the Adobe transform
   0, 1 and 2; EXIF orientations 1-8), and from them: baseline files
   without their DHT segments (MJPEG frames), sequential arithmetic-coded
   (SOF9) transcodes (``scripts/make_jpeg_fixtures.py``'s encoder), and
   progressive files cut at random points with and without an EOI marker
   after (smoothed); the plain path (``utils/jpeg.py``) must be exact on
   each.
2. ``ops/kernels/csrc/jpeg.cu`` is built with g++ (its kernel is under
   ``__CUDACC__``; the steps of its CTA are ``__host__ __device__``, and
   ``scl_jpeg_pixels_host`` runs them thread by thread), and on every file
   of (1) in both modes its entropy decoder must refuse where the plain
   decoder does or give its coefficients, tables and frame, and J1's CTAs
   the plain pixel stage's image, each file alone and all in one batch.
3. Cuts (with and without an EOI marker after) and single-byte changes of
   five files (baseline, progressive, restart intervals, arithmetic-coded,
   CMYK): in both modes both entropy decoders must agree, and the plain
   path must be exact against OpenCV.

It prints one line per part and exits non-zero on any disagreement.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tempfile

import cv2
import numpy as np
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from make_jpeg_fixtures import arithmetic_transcode, without_dht  # noqa: E402
from soft_contrastive_learning_torch.ops.kernels.jpeg import (  # noqa: E402
    build_host_library, pixels_on_host)
from soft_contrastive_learning_torch.utils import jpeg  # noqa: E402

MODES = ("file", "buffer")

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
                for extra, what in (([], "[]"), ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1], "PROGRESSIVE"),
                                    ([cv2.IMWRITE_JPEG_RST_INTERVAL, 3], "RST3")):
                    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                              samp, *extra]
                    out.append((f"{h}x{w} {samp:#x} q{q} {what}",
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
    for _ in range(24):  # PIL's CMYK, its Adobe transform 0 (CMYK), 1 or 2 (YCCK)
        h, w = (int(v) for v in rng.integers(1, 120, 2))
        sub, transform = int(rng.integers(0, 3)), int(rng.integers(0, 3))
        buf = io.BytesIO()
        Image.fromarray(textured(rng, h, w)).convert("CMYK").save(
            buf, "JPEG", quality=int(rng.integers(20, 100)), subsampling=sub,
            progressive=bool(rng.integers(0, 2)))
        data = bytearray(buf.getvalue())
        data[data.find(b"\xff\xee") + 15] = transform
        out.append((f"{h}x{w} CMYK sub{sub} transform{transform}", bytes(data)))
    baseline = [(n, d) for n, d in out if "[]" in n and "gray" not in n]
    for name, data in baseline[::3]:
        out.append((f"{name} without DHT", without_dht(data)))
        out.append((f"{name} SOF9 transcode", arithmetic_transcode(data)))
    progressive = [(n, d) for n, d in out if "PROGRESSIVE" in n or "progTrue" in n]
    for name, data in progressive[::2]:
        cut = int(rng.integers(3, len(data)))
        out.append((f"{name} cut {cut}", data[:cut]))
        out.append((f"{name} cut {cut}+EOI", data[:cut] + b"\xff\xd9"))
    return out


def native(dll, data, source="buffer"):
    """``ops/kernels/jpeg.py::entropy_decode`` on the g++ build."""
    import soft_contrastive_learning_torch.ops.kernels.jpeg as kj

    real = kj._lib
    kj._lib = lambda: dll
    try:
        return kj.entropy_decode(data, "f", source)
    finally:
        kj._lib = real


def outcome(fn, data, mode):
    try:
        co = fn(data, mode)
        return "ok", co.coefs.tobytes() + co.quant.tobytes() + repr(co.frame).encode()
    except ValueError as e:
        return "refused", str(e)


def opencv(data: bytes, mode: str):
    """cv2.imread / cv2.imdecode of ``data`` as RGB, None for no image."""
    if mode == "file":
        with tempfile.NamedTemporaryFile(suffix=".jpg") as f:
            f.write(data)
            f.flush()
            bgr = cv2.imread(f.name)
    else:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])


def against_opencv(data: bytes, mode: str) -> str:
    """``exact``, ``lanes`` (the recorded divergence) or what differs."""
    want = opencv(data, mode)
    try:
        co = jpeg.decode_coefficients(data, "f", mode)
    except ValueError as e:
        return "exact" if want is None else f"refused where OpenCV decodes: {e}"
    if want is None:
        return "decoded where OpenCV gives no image"
    coefs, quant = torch.from_numpy(co.coefs), torch.from_numpy(co.quant)
    got = jpeg.pixels_plain(coefs, quant, co.frame).numpy()
    if got.shape == want.shape and (got == want).all():
        return "exact"
    if not jpeg.idct_in_16_bit_lanes(coefs, quant, co.frame):
        return "lanes"
    return f"pixels differ ({int((got != want).sum())})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fuzz", type=int, default=300, help="byte changes per file in part 3")
    args = p.parse_args(argv)
    bad = 0
    sweep = files()
    tally = {"exact": 0, "lanes": 0}
    for name, data in sweep:
        for mode in MODES:
            verdict = against_opencv(data, mode)
            if verdict in tally:
                tally[verdict] += 1
            else:
                bad += 1
                print(f"plain decode not exact ({mode}): {name}: {verdict}")
    print(f"1. {len(sweep)} OpenCV/PIL files and their cuts, MJPEG frames and SOF9 transcodes "
          f"in both modes: {tally['exact']} exact, {tally['lanes']} outside the 16-bit lanes, "
          f"{bad} not exact")
    with tempfile.TemporaryDirectory() as tmp:
        dll = build_host_library(tmp)
        wrong = checked = 0
        batch, plains = [], []
        for name, data in sweep:
            for mode in MODES:
                a = outcome(lambda x, m: jpeg.decode_coefficients(x, name, m), data, mode)
                b = outcome(lambda x, m: native(dll, x, m), data, mode)
                if a[0] != b[0] or (a[0] == "ok" and a[1] != b[1]):
                    wrong += 1
                    print(f"compiled decoder differs ({mode}): {name}")
                    continue
                if a[0] == "refused":
                    continue
                co = native(dll, data, mode)
                plain = jpeg.pixels_plain(torch.from_numpy(co.coefs), torch.from_numpy(co.quant),
                                          co.frame).numpy()
                checked += 1
                batch.append(co)
                plains.append(plain)
                if not np.array_equal(pixels_on_host(dll, [co])[0], plain):
                    wrong += 1
                    print(f"J1's CTAs differ ({mode}): {name}")
        for co, got, plain in zip(batch, pixels_on_host(dll, batch), plains):
            if not np.array_equal(got, plain):
                wrong += 1
                print(f"J1's CTAs differ in the batch of all: {co.frame}")
        print(f"2. the same files: the g++-built entropy decoder equals the plain one on "
              f"{2 * len(sweep) - wrong} of {2 * len(sweep)} decodes, J1's CTAs run on the "
              f"host the plain pixel stage on {checked} images alone and in one batch; {wrong} "
              "differ")
        bad += wrong
        rng = np.random.default_rng(5)
        im = rng.integers(0, 255, (40, 56, 3), np.uint8)
        seeds = [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 80, *extra])[1].tobytes()
                 for extra in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                               [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])]
        seeds.append(arithmetic_transcode(seeds[0], restart=2))
        buf = io.BytesIO()
        Image.fromarray(im).convert("CMYK").save(buf, "JPEG", quality=80, subsampling=2)
        seeds.append(buf.getvalue())
        cases = []
        for s in seeds:
            cases += [s[:cut] for cut in range(3, len(s), 11)]
            cases += [s[:cut] + b"\xff\xd9" for cut in range(3, len(s), 23)]
            for _ in range(args.fuzz):
                d = bytearray(s)
                d[rng.integers(2, len(d))] = rng.integers(0, 256)
                cases.append(bytes(d))
        counts = {"refused": 0, "ok": 0}
        differ = 0
        verdicts = {"exact": 0, "lanes": 0}
        for d in cases:
            for mode in MODES:
                a = outcome(lambda x, m: jpeg.decode_coefficients(x, "f", m), d, mode)
                b = outcome(lambda x, m: native(dll, x, m), d, mode)
                if a[0] != b[0] or (a[0] == "ok" and a[1] != b[1]):
                    differ += 1
                    print(f"decoders differ ({mode}): {a[0]} / {b[0]}: "
                          f"{a[1][:160] if a[0] == 'refused' else ''} | "
                          f"{b[1][:160] if b[0] == 'refused' else ''}")
                else:
                    counts[a[0]] += 1
                verdict = against_opencv(d, mode)
                if verdict in verdicts:
                    verdicts[verdict] += 1
                else:
                    differ += 1
                    print(f"plain decode not exact ({mode}): {verdict}")
        print(f"3. {len(cases)} cut or changed files in both modes: both decoders refused "
              f"{counts['refused']}, gave the same coefficients for {counts['ok']}; against "
              f"OpenCV {verdicts['exact']} exact, {verdicts['lanes']} outside the 16-bit "
              f"lanes; {differ} differ")
        bad += differ
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
