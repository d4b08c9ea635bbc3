"""Write the JPEG fixtures the port's decoder is held to on the card.

The card's machine has no OpenCV or PIL, so the fixtures carry their own
answers: each file under ``soft_contrastive_learning_torch/assets/jpeg/`` is
listed in ``digests.json`` with, for each of OpenCV's two readers, the
SHA-256 of the (H, W, 3) uint8 RGB array (C order) and its shape, or the
words the port's refusal must hold where OpenCV gives no image: ``file`` is
``cv2.imread`` of the file (what ``utils/io.py::load_img`` matches), and
``buffer`` is ``cv2.imdecode`` of its bytes (``decode_img``, the service's
uploads), each then BGR -> RGB, on the machine that ran this script. Files
that OpenCV decodes but the port does not match, by a divergence the port
records, are listed under ``diverges`` with the reason. Run it where OpenCV
and PIL are installed:

    python scripts/make_jpeg_fixtures.py [--out DIR]

The images are toy-city views with seeded noise (texture for the AC
coefficients), at 180x240 unless named otherwise: 4:2:0 at quality 95
(OpenCV's default), 4:4:4, 4:2:2, 4:4:0, 4:1:1, gray, progressive (PIL and
OpenCV), restart interval 3, 181x243, EXIF orientations 2-8, an Adobe RGB
file and one 1280x960 frame (RobotCar's size) at quality 90. Then the files
that exercise libjpeg's recovery and its rarer formats: a baseline file cut
without and with an EOI marker; progressive files cut at three points
(the decoder smooths their blocks), one of them a 1280x960 frame; a run of
ones that reads as a bad Huffman code, a restart marker dropped and bytes
put before one; MJPEG frames (the DHT segments taken out, so the default
tables decode them) at 1280x960 and 180x240; PIL's CMYK file and a 4:2:0
one with its Adobe transform patched to 2 (YCCK); SOF9 patched onto a
small baseline file and SOF10 onto the PIL progressive file; a progressive
file without its DHT segments (no default tables: refused, as OpenCV
refuses it); and real SOF9 (arithmetic-coded) transcodes, written by the encoder below from the
coefficients of committed Huffman fixtures, which OpenCV must decode to
the Huffman originals' pixels. A 32x48 file is the seed of the tests' cuts
and byte changes.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import tempfile

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from soft_contrastive_learning_torch.data.toycity import ToyCity  # noqa: E402
from soft_contrastive_learning_torch.utils import jpeg  # noqa: E402

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


def pil_jpeg(rgb: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def exif(orientation: int) -> bytes:
    ex = Image.Exif()
    ex[0x0112] = orientation
    return ex.tobytes()


def segments(data: bytes):
    """(code, start, end) of each marker segment before the first scan."""
    out, at = [], 2
    while data[at + 1] != 0xDA:
        length = data[at + 2] << 8 | data[at + 3]
        out.append((data[at + 1], at, at + 2 + length))
        at += 2 + length
    return out, at


def without_dht(data: bytes) -> bytes:
    """An MJPEG frame: the file with its DHT segments taken out."""
    segs, sos = segments(data)
    return data[:2] + b"".join(data[s:e] for code, s, e in segs if code != 0xC4) + data[sos:]


def without_dht_all(data: bytes) -> bytes:
    """A progressive file with every DHT segment taken out, those between
    its scans too: libjpeg has no default tables for progressive frames, and
    OpenCV refuses it."""
    out, at = bytearray(data[:2]), 2
    while data[at + 1] != 0xD9:
        end = data.find(b"\xff", at + 2)
        while data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
            end = data.find(b"\xff", end + 2)
        if data[at + 1] != 0xC4:
            out += data[at:end]
        at = end
    return bytes(out + data[at:])


def patched(data: bytes, at: int, value: int) -> bytes:
    out = bytearray(data)
    out[at] = value
    return bytes(out)


def sof_at(data: bytes) -> int:
    return next(s for code, s, _ in segments(data)[0] if 0xC0 <= code <= 0xCF and code != 0xC4)


def sos_positions(data: bytes):
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


def opencv_warnings(data: bytes) -> str:
    """What libjpeg says on stderr while cv2.imdecode decodes ``data``."""
    saved = os.dup(2)
    with tempfile.TemporaryFile() as log:
        os.dup2(log.fileno(), 2)
        try:
            cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        log.seek(0)
        return log.read().decode(errors="replace")


# ---------------------------------------------------------------- arithmetic
class ArithEncoder:
    """libjpeg's arithmetic encoder (``jcarith.c``, T.81 Annex D) for
    sequential scans, with the decoder's tables (``utils/jpeg.py``)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_stacked(self, value: int) -> None:
        if self.zc:
            self.out += b"\x00" * self.zc
            self.zc = 0
        self.out.append(value)

    def encode(self, st: bytearray, at: int, val: int) -> None:
        sv = st[at]
        qe = jpeg.ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[at] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[at] = (sv & 0x80) ^ nm
        while True:  # renormalize, output bytes (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:  # a carry over the stacked 0xFF bytes
                    if self.buffer >= 0:
                        self._emit_stacked(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_stacked(self.buffer)
                    if self.sc:
                        self._emit_stacked(0xFF)
                        self.out.append(0)
                        self.out += b"\xff\x00" * (self.sc - 1)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        """jcarith.c finish_pass: the shortest tail that ends in the interval."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_stacked(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_stacked(self.buffer)
            if self.sc:
                self._emit_stacked(0xFF)
                self.out.append(0)
                self.out += b"\xff\x00" * (self.sc - 1)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._emit_stacked((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                self.out.append((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self.out.append(0)


def encode_block(enc: ArithEncoder, block: np.ndarray, state: dict, k: int, dc_tbl: int,
                 ac_tbl: int, cond: dict) -> None:
    """One block (Figures F.4-F.9, jcarith.c encode_mcu)."""
    dcs, acs, fixed = state["dc"][dc_tbl], state["ac"][ac_tbl], state["fixed"]
    lo, hi = cond["dc"].get(dc_tbl, (0, 1))
    st = state["ctx"][k]
    v = int(block[0]) - state["last"][k]
    if v == 0:
        enc.encode(dcs, st, 0)
        state["ctx"][k] = 0
    else:
        state["last"][k] = int(block[0])
        enc.encode(dcs, st, 1)
        if v > 0:
            enc.encode(dcs, st + 1, 0)
            at, state["ctx"][k] = st + 2, 4
        else:
            v = -v
            enc.encode(dcs, st + 1, 1)
            at, state["ctx"][k] = st + 3, 8
        m = 0
        v -= 1
        if v:
            enc.encode(dcs, at, 1)
            m, v2, at = 1, v, 20
            v2 >>= 1
            while v2:
                enc.encode(dcs, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
        enc.encode(dcs, at, 0)
        if m < (1 << lo) >> 1:
            state["ctx"][k] = 0
        elif m > (1 << hi) >> 1:
            state["ctx"][k] += 8
        at += 14
        m >>= 1
        while m:
            enc.encode(dcs, at, 1 if m & v else 0)
            m >>= 1
    nat = jpeg.ZIGZAG
    kk = cond["ac"].get(ac_tbl, 5)
    ke = 63
    while ke > 0 and block[nat[ke]] == 0:
        ke -= 1
    i = 1
    while i <= ke:
        at = 3 * (i - 1)
        enc.encode(acs, at, 0)  # not the end of the block
        while block[nat[i]] == 0:
            enc.encode(acs, at + 1, 0)
            at += 3
            i += 1
        enc.encode(acs, at + 1, 1)
        v = int(block[nat[i]])
        enc.encode(fixed, 0, 0 if v > 0 else 1)
        v = abs(v)
        at += 2
        m = 0
        v -= 1
        if v:
            enc.encode(acs, at, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc.encode(acs, at, 1)
                m <<= 1
                at = 189 if i <= kk else 217
                v2 >>= 1
                while v2:
                    enc.encode(acs, at, 1)
                    m <<= 1
                    at += 1
                    v2 >>= 1
        enc.encode(acs, at, 0)
        at += 14
        m >>= 1
        while m:
            enc.encode(acs, at, 1 if m & v else 0)
            m >>= 1
        i += 1
    if i <= 63:
        enc.encode(acs, 3 * (i - 1), 1)


def arithmetic_transcode(data: bytes, restart: int = 0, dac: dict | None = None) -> bytes:
    """A baseline Huffman file as a sequential arithmetic-coded one (SOF9):
    the same tables, frame and coefficients, one interleaved scan, with a
    restart interval and DAC conditioning where asked."""
    co = jpeg.decode_coefficients(data, "transcode")
    f = co.frame
    segs, sos = segments(data)
    body = bytearray(data[:2])
    for code, s, e in segs:
        if code == 0xC0:
            body += b"\xff\xc9" + data[s + 2 : e]
        elif code not in (0xC4, 0xDD):
            body += data[s:e]
    dac = dac or {"dc": {}, "ac": {}}
    pairs = [(t, (hi << 4) | lo) for t, (lo, hi) in dac["dc"].items()]
    pairs += [(16 + t, kk) for t, kk in dac["ac"].items()]
    if pairs:
        body += b"\xff\xcc" + (2 + 2 * len(pairs)).to_bytes(2, "big") + bytes(
            v for pair in pairs for v in pair)
    if restart:
        body += b"\xff\xdd\x00\x04" + restart.to_bytes(2, "big")
    slen = data[sos + 2] << 8 | data[sos + 3]
    header = data[sos + 4 : sos + 2 + slen]
    ns = header[0]
    assert ns == len(f.components)
    tables = [(header[2 + 2 * k] >> 4, header[2 + 2 * k] & 15) for k in range(ns)]
    body += data[sos : sos + 2 + slen]
    hmax, vmax = f.hmax, f.vmax
    mx, my = -(-f.width // (8 * hmax)), -(-f.height // (8 * vmax))
    at = f.block_offsets()
    enc = ArithEncoder()

    def fresh():
        return {"dc": {t[0]: bytearray(jpeg.DC_STAT_BINS) for t in tables},
                "ac": {t[1]: bytearray(jpeg.AC_STAT_BINS) for t in tables},
                "fixed": bytearray([jpeg.FIXED_BIN]), "last": [0] * ns, "ctx": [0] * ns}

    state = fresh()
    for m in range(mx * my):
        if restart and m and m % restart == 0:
            enc.finish()
            enc.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            enc.reset()
            state = fresh()
        r, q = divmod(m, mx)
        for k, c in enumerate(f.components):
            for y in range(c.v):
                for x in range(c.h):
                    block = co.coefs[at[k] + (r * c.v + y) * c.bw + q * c.h + x]
                    encode_block(enc, block, state, k, tables[k][0], tables[k][1], dac)
    enc.finish()
    return bytes(body + enc.out + b"\xff\xd9")


# ---------------------------------------------------------------- the fixtures
def fixtures():
    S = cv2
    img = view(180, 240, 3, 7)
    frame = view(960, 1280, 2, 9)
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
        "frame_1280x960.jpg": cv2_jpeg(frame, S.IMWRITE_JPEG_QUALITY, 90),
        "small_32x48.jpg": cv2_jpeg(view(32, 48, 4, 5), S.IMWRITE_JPEG_QUALITY, 75),
    }
    for o in range(2, 9):
        files[f"orient{o}.jpg"] = pil_jpeg(img, quality=90, exif=exif(o))
    small = cv2_jpeg(view(16, 24, 1, 3))
    sof = sof_at(small)
    base, prog = files["c420_q95.jpg"], files["progressive_cv2.jpg"]
    frame_prog = cv2_jpeg(frame, S.IMWRITE_JPEG_QUALITY, 90, S.IMWRITE_JPEG_PROGRESSIVE, 1)
    restart = files["restart3.jpg"]
    rst3 = restart.find(b"\xff\xd3")
    bad_code = bytearray(base)
    bad_code[len(base) - 1000 : len(base) - 994] = b"\xff\x00" * 3  # 24 ones
    cmyk420 = bytearray(pil_jpeg(img, "CMYK", quality=90, subsampling=2))
    adobe = cmyk420.find(b"\xff\xeeAdobe"[:2]) + 4 + 11
    assert cmyk420[adobe - 11 : adobe - 6] == b"Adobe"
    cmyk420[adobe] = 2
    pil_prog = files["progressive_pil.jpg"]
    files.update({
        "truncated_no_eoi.jpg": base[: len(base) // 2],
        "truncated_eoi.jpg": base[: len(base) // 2] + b"\xff\xd9",
        "progressive_cut_fifth.jpg": prog[: len(prog) // 5],
        "progressive_cut_2_3.jpg": prog[: 2 * len(prog) // 3] + b"\xff\xd9",
        "frame_progressive_cut.jpg": frame_prog[: sos_positions(frame_prog)[6]] + b"\xff\xd9",
        "corrupt_huffman.jpg": bytes(bad_code),
        "dropped_rst.jpg": restart[:rst3] + restart[rst3 + 2 :],
        "junk_before_rst.jpg": restart[:rst3] + b"\x12\x34\x56" + restart[rst3:],
        "mjpeg_1280x960.jpg": without_dht(files["frame_1280x960.jpg"]),
        "mjpeg_180x240.jpg": without_dht(base),
        "cmyk_pil.jpg": pil_jpeg(img, "CMYK", quality=90),
        "ycck_420.jpg": bytes(cmyk420),
        "cmyk_16x24.jpg": pil_jpeg(view(16, 24, 1, 3), "CMYK", quality=90),
        "arith_sof9_patched.jpg": patched(small, sof + 1, 0xC9),
        "progressive_pil_sof10.jpg": patched(pil_prog, sof_at(pil_prog) + 1, 0xCA),
        "c420_q95_arith.jpg": arithmetic_transcode(base),
        "restart3_arith_dac.jpg": arithmetic_transcode(
            restart, restart=3, dac={"dc": {0: (1, 3), 1: (0, 2)}, "ac": {0: 10, 1: 2}}),
        "frame_1280x960_arith.jpg": arithmetic_transcode(files["frame_1280x960.jpg"]),
        "refused_progressive_no_dht.jpg": without_dht_all(prog),
        "refused_lossless.jpg": patched(small, sof + 1, 0xC3),
        "refused_12bit.jpg": patched(small, sof + 4, 12),
    })
    diverges = {
        # garbage arithmetic decoding of Huffman data: coefficients whose IDCT
        # leaves libjpeg-turbo's 16-bit SIMD lanes
        "progressive_cv2_sof10.jpg": (patched(prog, sof_at(prog) + 1, 0xCA), "16-bit"),
    }
    checks = {
        "corrupt_huffman.jpg": "bad Huffman code",
        "dropped_rst.jpg": "extraneous bytes before marker",
        "junk_before_rst.jpg": "3 extraneous bytes before marker",
    }
    same_as = {"mjpeg_1280x960.jpg": "frame_1280x960.jpg", "mjpeg_180x240.jpg": "c420_q95.jpg",
               "c420_q95_arith.jpg": "c420_q95.jpg", "restart3_arith_dac.jpg": "restart3.jpg",
               "frame_1280x960_arith.jpg": "frame_1280x960.jpg"}
    return files, diverges, checks, same_as


def opencv_reads(path: str, data: bytes):
    """{mode: RGB array or None} as cv2.imread / cv2.imdecode read it."""
    out = {"file": cv2.imread(path), "buffer": cv2.imdecode(np.frombuffer(data, np.uint8),
                                                              cv2.IMREAD_COLOR)}
    return {k: None if v is None else np.ascontiguousarray(v[..., ::-1]) for k, v in out.items()}


# the words of the port's refusal where OpenCV gives no image
REASONS = {"refused_lossless.jpg": "lossless", "refused_12bit.jpg": "12-bit",
           "refused_progressive_no_dht.jpg": "Huffman table"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for old in os.listdir(args.out):
        if old.endswith(".jpg"):
            os.remove(os.path.join(args.out, old))
    files, diverges, checks, same_as = fixtures()
    table = {"opencv": cv2.__version__, "fixtures": {}, "diverges": {}}
    pixels = {}
    for name, data in files.items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        entry = {}
        for mode, rgb in opencv_reads(path, data).items():
            if rgb is None:
                entry[mode] = {"refused": REASONS.get(name, "truncated")}
            else:
                entry[mode] = {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                               "shape": list(rgb.shape)}
                pixels[name, mode] = rgb
        table["fixtures"][name] = entry
    for name, words in checks.items():
        said = opencv_warnings(files[name])
        if words not in said:
            raise SystemExit(f"{name}: libjpeg said {said!r}, expected {words!r}")
    for name, original in same_as.items():  # the transcodes and MJPEG frames
        for mode in ("file", "buffer"):
            if not np.array_equal(pixels[name, mode], pixels[original, mode]):
                raise SystemExit(f"{name}: OpenCV's pixels differ from {original}'s")
    for name, (data, why) in diverges.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
        table["diverges"][name] = why
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in os.listdir(args.out))
    print(f"{len(files)} fixtures and {len(diverges)} recorded divergences, {total / 1e6:.3f} MB "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
