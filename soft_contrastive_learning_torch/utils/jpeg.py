"""JPEG decoding to OpenCV's bits: the parser, the plain entropy decoder and
the plain pixel stage.

``cv2.imread`` / ``cv2.imdecode(IMREAD_COLOR)`` decode a JPEG with the
libjpeg-turbo that OpenCV bundles, at libjpeg's defaults: the integer
``JDCT_ISLOW`` IDCT (``jidctint.c``), "fancy" triangular chroma upsampling
(``jdsample.c``) and the fixed-point YCbCr -> RGB of ``jdcolor.c``, and then
OpenCV turns the image by its EXIF orientation. All of it is exact integer
arithmetic, so the port reproduces it bit for bit in two stages:

* the entropy stage: markers, Huffman tables, the baseline, extended and
  progressive scans with restart intervals -> each component's quantized
  coefficients as int16 ``(blocks_h, blocks_w, 64)`` in natural order, its
  quantization table, and the frame's geometry (``Coefficients``).
  ``decode_coefficients`` is the plain version in Python; the compiled one
  (host C++ in ``ops/kernels/csrc/jpeg.cu``, called by
  ``ops/kernels/jpeg.py``) gives the same arrays and releases the GIL;
* the pixel stage: dequantize, the islow IDCT, upsample, colour-convert,
  crop and orient -> (H, W, 3) RGB uint8. ``pixels_plain`` is the plain
  version in integer torch ops on any device; J1
  (``ops/kernels/jpeg.py::jpeg_pixels_cuda``) is the hand kernel.

What is decoded: SOF0, SOF1 and SOF2 frames at 8-bit precision with 1
(gray, returned as three equal channels) or 3 components (YCbCr, or RGB
where an Adobe APP14 marker or the component ids say so), any integral
sampling factors up to 4, restart intervals, and the EXIF orientation of an
APP1 segment (either byte order). Refused with a ``ValueError`` that names
the file and the reason: arithmetic coding (SOF9-11), lossless (SOF3),
hierarchical frames, 12- and 16-bit precision, 2 or 4 components (CMYK,
YCCK), fractional sampling, a scan that names a Huffman table the file does
not define, truncated or corrupt entropy data (libjpeg warns, fills the
rest with grey and OpenCV returns the image), and a progressive file whose
scans leave some of the first ten coefficients of a component not fully
known (libjpeg would smooth its blocks, ``jdcoefct.c``; a complete
progressive file is not smoothed).

The IDCT's final range limit is a clamp to [0, 255], as in libjpeg-turbo's
SIMD code, which is what OpenCV runs on x86-64 (``jidctint.c``'s table
wraps values 512 or more away from the range instead; a valid file never
reaches them). Coefficients far outside the 11-bit range a DCT of 8-bit
samples gives overflow the SIMD code's 16-bit lanes; the port computes
them exactly and does not follow it there.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# zigzag position k -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
# libjpeg's jpeg_natural_order: 16 more entries at 63, where corrupt data
# that runs past a block's end writes
_NAT = ZIGZAG.tolist() + [63] * 16

# colour transforms of the frame: how the components become RGB
GRAY, YCC, RGB = 0, 1, 2

_SOF_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
# libjpeg-turbo 2.1+ smooths blocks by the DC and the first nine AC
# coefficients (jdcoefct.c SAVED_COEFS)
SMOOTHING_COEFS = 10


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


@dataclass
class Component:
    cid: int
    h: int  # sampling factors
    v: int
    tq: int  # quantization table id
    dw: int = 0  # samples the component holds: ceil(W * h / hmax)
    dh: int = 0
    bw: int = 0  # blocks in its coefficient array (whole MCUs)
    bh: int = 0


@dataclass
class Frame:
    """A frame's geometry and colour, what the pixel stage needs besides
    the coefficients."""

    height: int
    width: int
    colour: int  # GRAY, YCC or RGB
    orientation: int  # EXIF 1-8
    components: List[Component]

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)

    def block_offsets(self) -> List[int]:
        """Each component's first block in the flat coefficient buffer, and
        the total."""
        out = [0]
        for c in self.components:
            out.append(out[-1] + c.bw * c.bh)
        return out

    def output_shape(self) -> Tuple[int, int]:
        """(rows, columns) after the orientation: 5-8 swap the axes."""
        return (self.width, self.height) if self.orientation >= 5 else (self.height, self.width)


@dataclass
class Coefficients:
    """The entropy stage's output, what the pixel stage takes."""

    frame: Frame
    coefs: np.ndarray  # (blocks, 64) int16, natural order: each component's (bh, bw) in turn
    quant: np.ndarray  # (ncomp, 64) int32, natural order


# ---------------------------------------------------------------- EXIF
def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of a TIFF header (``II`` or
    ``MM``), 1 where it is missing, malformed or not 1-8."""
    try:
        order = {b"II": "<", b"MM": ">"}[tiff[:2]]
        (magic, ifd) = struct.unpack(order + "HI", tiff[2:8])
        if magic != 42:
            return 1
        (n,) = struct.unpack(order + "H", tiff[ifd : ifd + 2])
        for i in range(n):
            at = ifd + 2 + 12 * i
            tag, kind = struct.unpack(order + "HH", tiff[at : at + 4])
            if tag == 0x0112:
                if kind != 3:  # SHORT
                    return 1
                (value,) = struct.unpack(order + "H", tiff[at + 8 : at + 10])
                return value if 1 <= value <= 8 else 1
    except (KeyError, struct.error):
        pass
    return 1


# ---------------------------------------------------------------- markers
@dataclass
class _Scan:
    comps: List[int]  # indices into the frame's components
    td: List[int]  # DC table per scan component
    ta: List[int]  # AC table per scan component
    ss: int
    se: int
    ah: int
    al: int
    restart: int  # the restart interval in force (MCUs), 0 for none
    segments: list  # entropy-coded bytes, unstuffed, one per restart interval
    truncated: bool  # the data ran into the end of the file
    restart_numbers: list = field(default_factory=list)  # n of each RSTn met


@dataclass
class _Parsed:
    height: int = 0
    width: int = 0
    progressive: bool = False
    components: List[Component] = field(default_factory=list)
    colour: int = YCC
    orientation: int = 1
    scans: List[_Scan] = field(default_factory=list)
    quant: Dict[int, np.ndarray] = field(default_factory=dict)
    latched: Dict[int, np.ndarray] = field(default_factory=dict)  # per component index
    saw_jfif: bool = False
    saw_exif: bool = False
    adobe: Optional[int] = None
    huff: list = field(default_factory=list)  # per scan: ({dc id: table}, {ac id: table})


def _entropy_segments(data: bytes, pos: int, path: str):
    """The entropy-coded data from ``pos`` on: unstuffed bytes split at
    restart markers (each with its marker number), the position of the
    marker that ends the scan, and whether the file ended first. Any run of
    0xFF before a byte counts as one 0xFF (libjpeg's fill bytes)."""
    segs, nums = [], []
    out = bytearray()
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            out += data[pos:]
            segs.append(bytes(out))
            return segs, nums, n, True
        out += data[pos:i]
        j = i + 1
        while j < n and data[j] == 0xFF:
            j += 1
        if j >= n:
            segs.append(bytes(out))
            return segs, nums, n, True
        code = data[j]
        if code == 0:
            out.append(0xFF)
            pos = j + 1
        elif 0xD0 <= code <= 0xD7:
            segs.append(bytes(out))
            nums.append(code - 0xD0)
            out = bytearray()
            pos = j + 1
        else:
            segs.append(bytes(out))
            return segs, nums, j - 1, False


def _huffman_table(counts: bytes, symbols: bytes, path: str) -> list:
    """A 16-bit lookup: entry ``(length << 8) | symbol`` for every 16-bit
    window that starts with the code, 0 where no code starts it."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError(f"{path}: JPEG Huffman table is over-subscribed (corrupt)")
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _parse(data: bytes, path: str) -> _Parsed:
    if not is_jpeg(data):
        raise ValueError(f"{path}: not a JPEG file")
    st = _Parsed()
    dc: Dict[int, list] = {}
    ac: Dict[int, list] = {}
    restart = 0
    pos = 2
    n = len(data)
    seen_sof = False
    while True:
        # find the next marker: 0xFF, any fill 0xFF, then its code
        if pos >= n:
            if not st.scans:
                raise ValueError(f"{path}: JPEG ends before its first scan (truncated)")
            return st  # no EOI after the last scan: libjpeg reads on as cv2 does
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: JPEG marker expected at byte {pos} (corrupt)")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{path}: JPEG truncated in a marker")
        code = data[pos]
        pos += 1
        if code == 0xD9:  # EOI
            if not st.scans:
                raise ValueError(f"{path}: JPEG has no scan")
            return st
        if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:  # SOI, TEM, stray RST
            continue
        if pos + 2 > n:
            raise ValueError(f"{path}: JPEG truncated in a marker segment")
        (length,) = struct.unpack(">H", data[pos : pos + 2])
        body = data[pos + 2 : pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"{path}: JPEG truncated in marker 0x{code:02X}'s segment")
        pos += length
        if code in _SOF_REFUSED:
            raise ValueError(f"{path}: {_SOF_REFUSED[code]} JPEG; the port decodes baseline, "
                             "extended and progressive Huffman JPEG only")
        if code in (0xC0, 0xC1, 0xC2):
            if seen_sof:
                raise ValueError(f"{path}: JPEG has two frame headers (corrupt)")
            seen_sof = True
            _parse_sof(st, code, body, path)
        elif code == 0xC4:
            at = 0
            while at < len(body):
                if at + 17 > len(body):
                    raise ValueError(f"{path}: JPEG DHT segment is short (corrupt)")
                tc, th = body[at] >> 4, body[at] & 15
                counts = body[at + 1 : at + 17]
                total = sum(counts)
                syms = body[at + 17 : at + 17 + total]
                if tc > 1 or th > 3 or len(syms) != total or total > 256:
                    raise ValueError(f"{path}: JPEG DHT segment is malformed (corrupt)")
                (dc if tc == 0 else ac)[th] = _huffman_table(counts, syms, path)
                at += 17 + total
        elif code == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or at + 1 + size > len(body):
                    raise ValueError(f"{path}: JPEG DQT segment is malformed (corrupt)")
                raw = np.frombuffer(body[at + 1 : at + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = raw.astype(np.int32)
                st.quant[tq] = table
                at += 1 + size
        elif code == 0xDD:
            if len(body) != 2:
                raise ValueError(f"{path}: JPEG DRI segment is malformed (corrupt)")
            (restart,) = struct.unpack(">H", body)
        elif code == 0xDA:
            if not seen_sof:
                raise ValueError(f"{path}: JPEG scan before its frame header (corrupt)")
            scan = _parse_sos(st, body, restart, path)
            for ci in scan.comps:
                if ci not in st.latched:
                    tq = st.components[ci].tq
                    if tq not in st.quant:
                        raise ValueError(f"{path}: JPEG component uses quantization table {tq}, "
                                         "which the file does not define (corrupt)")
                    st.latched[ci] = st.quant[tq].copy()
            for k, ci in enumerate(scan.comps):
                need_dc = scan.ss == 0 and scan.ah == 0
                need_ac = scan.se > 0
                if (need_dc and scan.td[k] not in dc) or (need_ac and scan.ta[k] not in ac):
                    raise ValueError(f"{path}: JPEG scan names a Huffman table the file does "
                                     "not define; the port has no default tables")
            st.huff.append((dict(dc), dict(ac)))
            scan.segments, scan.restart_numbers, pos, scan.truncated = _entropy_segments(
                data, pos, path)
            st.scans.append(scan)
        elif code in (0xE0, 0xE1, 0xEE) and st.scans:
            pass  # libjpeg settles the colour and saves the Exif before the first scan
        elif code == 0xE0:
            if body[:5] == b"JFIF\x00" and len(body) >= 14:
                st.saw_jfif = True
        elif code == 0xE1:
            if body[:6] == b"Exif\x00\x00" and not st.saw_exif:
                st.saw_exif = True
                st.orientation = exif_orientation(body[6:])
        elif code == 0xEE:
            if body[:5] == b"Adobe" and len(body) >= 12:
                st.adobe = body[11]
        elif code == 0xDC:
            raise ValueError(f"{path}: JPEG with a DNL marker; the port decodes frames that "
                             "state their height")
        elif 0xC0 <= code <= 0xCF or code in (0xDE, 0xDF):
            raise ValueError(f"{path}: JPEG marker 0x{code:02X} is not supported")
        # other APPn, COM and reserved segments are skipped


def _parse_sof(st: _Parsed, code: int, body: bytes, path: str) -> None:
    if len(body) < 6:
        raise ValueError(f"{path}: JPEG frame header is short (corrupt)")
    precision, height, width, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit JPEG; the port decodes 8-bit samples only")
    if height == 0 or width == 0:
        raise ValueError(f"{path}: JPEG frame of {width}x{height} (a DNL height, or corrupt)")
    if nc not in (1, 3):
        what = "CMYK/YCCK" if nc == 4 else f"{nc}-component"
        raise ValueError(f"{path}: {what} JPEG; the port decodes gray and 3-component JPEG only")
    if len(body) != 6 + 3 * nc:
        raise ValueError(f"{path}: JPEG frame header has the wrong length (corrupt)")
    st.height, st.width, st.progressive = height, width, code == 0xC2
    for i in range(nc):
        cid, hv, tq = body[6 + 3 * i : 9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"{path}: JPEG component sampling {h}x{v} / table {tq} (corrupt)")
        st.components.append(Component(cid, h, v, tq))
    hmax = max(c.h for c in st.components)
    vmax = max(c.v for c in st.components)
    for c in st.components:
        if hmax % c.h or vmax % c.v:
            raise ValueError(f"{path}: JPEG with fractional sampling ({c.h}x{c.v} against "
                             f"{hmax}x{vmax}); libjpeg refuses it too")
        c.dw = -(-width * c.h // hmax)
        c.dh = -(-height * c.v // vmax)
        if nc == 1:  # one component: a non-interleaved frame of its own blocks
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
        else:
            c.bw = -(-width // (8 * hmax)) * c.h
            c.bh = -(-height // (8 * vmax)) * c.v
    if nc == 1:
        st.colour = GRAY
    else:
        ids = [c.cid for c in st.components]
        st.colour = YCC if ids != [82, 71, 66] else RGB  # 'R', 'G', 'B'


def _parse_sos(st: _Parsed, body: bytes, restart: int, path: str) -> _Scan:
    if not body:
        raise ValueError(f"{path}: JPEG scan header is empty (corrupt)")
    ns = body[0]
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise ValueError(f"{path}: JPEG scan header has the wrong length (corrupt)")
    comps, td, ta = [], [], []
    ids = [c.cid for c in st.components]
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids or ids.index(cid) in comps:
            raise ValueError(f"{path}: JPEG scan names component {cid} wrongly (corrupt)")
        comps.append(ids.index(cid))
        td.append(t >> 4)
        ta.append(t & 15)
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if st.progressive:
        bad = (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1))
        if bad or (ah and al != ah - 1) or al > 13:
            raise ValueError(f"{path}: JPEG progressive scan parameters Ss={ss} Se={se} Ah={ah} "
                             f"Al={al} are invalid (corrupt)")
    elif ss != 0 or se != 63 or ah or al:
        # libjpeg ignores these in a sequential frame and decodes all 64
        ss, se, ah, al = 0, 63, 0, 0
    if sum(st.components[c].h * st.components[c].v for c in comps) > 10 and ns > 1:
        raise ValueError(f"{path}: JPEG MCU of more than 10 blocks (corrupt)")
    return _Scan(comps, td, ta, ss, se, ah, al, restart, [], False)


# ---------------------------------------------------------------- entropy
class _Bits:
    """A bit reader over one unstuffed segment; past its end it reads zeros,
    as libjpeg fills when it meets a marker, and ``over`` says whether bits
    past the end were used."""

    __slots__ = ("win", "p", "nbits")

    def __init__(self, seg: bytes):
        a = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.uint32)
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()
        self.p = 0
        self.nbits = 8 * len(seg)


class _Corrupt(Exception):
    pass


def _mcu_blocks(st: _Parsed, scan: _Scan) -> Tuple[int, list]:
    """(number of MCUs, per MCU the (component index, flat block index)
    list) of a scan."""
    comps = st.components
    if len(scan.comps) == 1:
        ci = scan.comps[0]
        c = comps[ci]
        bw, bh = -(-c.dw // 8), -(-c.dh // 8)
        return bw * bh, [[(ci, r * c.bw + q)] for r in range(bh) for q in range(bw)]
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    mx, my = -(-st.width // (8 * hmax)), -(-st.height // (8 * vmax))
    mcus = []
    for r in range(my):
        for q in range(mx):
            blocks = []
            for ci in scan.comps:
                c = comps[ci]
                for y in range(c.v):
                    for x in range(c.h):
                        blocks.append((ci, (r * c.v + y) * c.bw + q * c.h + x))
            mcus.append(blocks)
    return mx * my, mcus


def _decode_scan(st: _Parsed, scan: _Scan, dc: dict, ac: dict, coefs: List[list],
                 path: str) -> None:
    """Decode one scan's entropy data into the flat coefficient lists."""
    n_mcu, mcus = _mcu_blocks(st, scan)
    per = scan.restart or n_mcu
    intervals = -(-n_mcu // per)
    segs = scan.segments
    if len(segs) < intervals:
        raise ValueError(f"{path}: JPEG scan ends after {len(segs)} of its {intervals} restart "
                         "intervals (truncated)")
    if any(segs[intervals:]):
        raise ValueError(f"{path}: JPEG scan has entropy data past its last restart interval "
                         "(corrupt)")
    for k, num in enumerate(scan.restart_numbers[: intervals - 1]):
        if num != k % 8:
            raise ValueError(f"{path}: JPEG restart marker RST{num} where RST{k % 8} belongs "
                             "(corrupt)")
    slot = {ci: k for k, ci in enumerate(scan.comps)}
    dctabs = [dc.get(t) for t in scan.td]
    actabs = [ac.get(t) for t in scan.ta]
    for iv in range(intervals):
        bits = _Bits(segs[iv])
        todo = mcus[iv * per : (iv + 1) * per]
        try:
            if not st.progressive:
                _baseline(bits, todo, slot, dctabs, actabs, coefs)
            elif scan.ss == 0:
                _dc_scan(bits, todo, slot, dctabs, coefs, scan.ah, scan.al)
            elif scan.ah == 0:
                _ac_first(bits, todo, actabs[0], coefs, scan.ss, scan.se, scan.al)
            else:
                _ac_refine(bits, todo, actabs[0], coefs, scan.ss, scan.se, scan.al)
        except _Corrupt as e:
            raise ValueError(f"{path}: JPEG entropy data is corrupt ({e})") from None
        except IndexError:  # ran past the zeros that pad the segment
            bits.p = bits.nbits + 1
        if bits.p > bits.nbits:
            why = "truncated" if scan.truncated and iv == intervals - 1 else "corrupt"
            raise ValueError(f"{path}: JPEG entropy data ends before the scan does ({why})")


def _huff(bits: _Bits, lut: list) -> int:
    p = bits.p
    e = lut[(bits.win[p >> 3] << (p & 7)) >> 16 & 0xFFFF]
    if not e:
        raise _Corrupt("a bad Huffman code")
    bits.p = p + (e >> 8)
    return e & 0xFF


def _receive(bits: _Bits, s: int) -> int:
    """``s`` bits, sign-extended as JPEG's HUFF_EXTEND."""
    p = bits.p
    v = ((bits.win[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
    bits.p = p + s
    return v if v >= 1 << (s - 1) else v - (1 << s) + 1


def _get(bits: _Bits, s: int) -> int:
    p = bits.p
    v = ((bits.win[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
    bits.p = p + s
    return v


def _baseline(bits, mcus, slot, dctabs, actabs, coefs):
    pred = [0] * len(slot)
    win = bits.win
    nat = _NAT
    for blocks in mcus:
        for ci, b in blocks:
            k = slot[ci]
            out = coefs[ci]
            base = b * 64
            s = _huff(bits, dctabs[k])
            if s:
                if s > 15:
                    raise _Corrupt("a DC difference of more than 15 bits")
                pred[k] += _receive(bits, s)
            out[base] = pred[k]
            lut = actabs[k]
            i = 1
            while i < 64:
                p = bits.p
                e = lut[(win[p >> 3] << (p & 7)) >> 16 & 0xFFFF]
                if not e:
                    raise _Corrupt("a bad Huffman code")
                p += e >> 8
                rs = e & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    i += r
                    v = ((win[p >> 3] << (p & 7)) >> (32 - s)) & ((1 << s) - 1)
                    p += s
                    out[base + nat[i]] = v if v >= 1 << (s - 1) else v - (1 << s) + 1
                    i += 1
                elif r == 15:
                    i += 16
                else:
                    bits.p = p
                    break
                bits.p = p


def _s16(v: int) -> int:
    """``v`` stored in a JCOEF (int16), as libjpeg stores the coefficients
    that a later progressive scan reads back."""
    return ((v + 32768) & 0xFFFF) - 32768


def _dc_scan(bits, mcus, slot, dctabs, coefs, ah, al):
    pred = [0] * len(slot)
    for blocks in mcus:
        for ci, b in blocks:
            out = coefs[ci]
            if ah == 0:
                k = slot[ci]
                s = _huff(bits, dctabs[k])
                if s:
                    if s > 15:
                        raise _Corrupt("a DC difference of more than 15 bits")
                    pred[k] += _receive(bits, s)
                out[b * 64] = _s16(pred[k] << al)
            elif _get(bits, 1):
                out[b * 64] = _s16(out[b * 64] | 1 << al)


def _ac_first(bits, mcus, lut, coefs, ss, se, al):
    eobrun = 0
    nat = _NAT
    for blocks in mcus:
        ci, b = blocks[0]
        if eobrun:
            eobrun -= 1
            continue
        out = coefs[ci]
        base = b * 64
        i = ss
        while i <= se:
            rs = _huff(bits, lut)
            r, s = rs >> 4, rs & 15
            if s:
                i += r
                out[base + nat[i]] = _s16(_receive(bits, s) << al)
            elif r == 15:
                i += 15
            else:
                eobrun = (1 << r) + (_get(bits, r) if r else 0) - 1
                break
            i += 1


def _ac_refine(bits, mcus, lut, coefs, ss, se, al):
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    nat = _NAT
    for blocks in mcus:
        ci, b = blocks[0]
        out = coefs[ci]
        base = b * 64
        i = ss
        if eobrun == 0:
            while i <= se:
                rs = _huff(bits, lut)
                r, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        raise _Corrupt("a refinement coefficient of more than one bit")
                    s = p1 if _get(bits, 1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (_get(bits, r) if r else 0)
                    break
                while i <= se:
                    at = base + nat[i]
                    c = out[at]
                    if c:
                        if _get(bits, 1) and not c & p1:
                            out[at] = _s16(c + (p1 if c >= 0 else m1))
                    else:
                        r -= 1
                        if r < 0:
                            break
                    i += 1
                if s:
                    out[base + nat[i]] = s
                i += 1
        if eobrun > 0:
            while i <= se:
                at = base + nat[i]
                c = out[at]
                if c and _get(bits, 1) and not c & p1:
                    out[at] = _s16(c + (p1 if c >= 0 else m1))
                i += 1
            eobrun -= 1


def _track_progression(coef_bits: np.ndarray, scan: _Scan, path: str) -> None:
    """Each coefficient's known bits, as libjpeg keeps them (``coef_bits``,
    -1 for none): a scan that refines bits not yet sent is refused."""
    for ci in scan.comps:
        row = coef_bits[ci]
        if scan.ss > 0 and row[0] < 0:
            raise ValueError(f"{path}: JPEG progression sends AC before DC (corrupt)")
        band = row[scan.ss : scan.se + 1]
        if (np.where(band < 0, 0, band) != scan.ah).any():
            raise ValueError(f"{path}: JPEG progression refines bits not sent (corrupt)")
        band[:] = scan.al


def _check_smoothing(coef_bits: np.ndarray, st: _Parsed, path: str) -> None:
    """Refuse a progressive file that libjpeg would smooth (``jdcoefct.c``
    ``smoothing_ok``): every component's DC known, its table's first ten
    entries non-zero, and some of its first ten coefficients unfinished."""
    quant_ok = all(
        ci in st.latched and (st.latched[ci][ZIGZAG[:SMOOTHING_COEFS]] != 0).all()
        for ci in range(len(st.components)))
    if quant_ok and (coef_bits[:, 0] >= 0).all() and (coef_bits[:, 1:SMOOTHING_COEFS] != 0).any():
        raise ValueError(f"{path}: progressive JPEG whose scans stop before its first "
                         "coefficients are whole; libjpeg smooths such blocks and the port "
                         "does not")


def decode_coefficients(data: bytes, path: str = "image") -> Coefficients:
    """The plain entropy stage: JPEG bytes -> ``Coefficients``."""
    st = _parse(data, path)
    comps = st.components
    coefs: List[list] = [[0] * (c.bw * c.bh * 64) for c in comps]
    coef_bits = np.full((len(comps), 64), -1, np.int64)
    for scan, (dc, ac) in zip(st.scans, st.huff):
        if st.progressive:
            _track_progression(coef_bits, scan, path)
        _decode_scan(st, scan, dc, ac, coefs, path)
    if st.progressive:
        _check_smoothing(coef_bits, st, path)
    for ci in range(len(comps)):
        if ci not in st.latched:
            raise ValueError(f"{path}: JPEG component {comps[ci].cid} is in no scan (corrupt)")
    colour = st.colour
    if len(comps) == 3 and not st.saw_jfif and st.adobe is not None:
        colour = RGB if st.adobe == 0 else YCC
    elif len(comps) == 3 and st.saw_jfif:
        colour = YCC
    flat = np.concatenate([np.asarray(c, np.int64) for c in coefs]).astype(np.int16)
    quant = np.stack([st.latched[ci] for ci in range(len(comps))]).astype(np.int32)
    frame = Frame(st.height, st.width, colour, st.orientation, comps)
    return Coefficients(frame, flat.reshape(-1, 64), quant)


# ---------------------------------------------------------------- pixels
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _idct_1d(x: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """One pass of ``jpeg_idct_islow`` over 8 inputs (int64 tensors), each
    output descaled by ``shift`` (round half up, arithmetic shift)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_plain(coefs: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """Dequantize and inverse-transform blocks: (..., 64) int16 natural-order
    coefficients and a (64,) table -> (..., 8, 8) uint8 samples, the islow
    IDCT's two passes (columns, then rows) and its range limit."""
    x = (coefs.to(torch.int64) * quant.to(torch.int64)).unflatten(-1, (8, 8))
    cols = _idct_1d([x[..., k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
    ws = torch.stack(cols, dim=-2)  # (..., row, col)
    rows = _idct_1d([ws[..., :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = torch.stack(rows, dim=-1)
    return (out + 128).clamp_(0, 255).to(torch.uint8)


def _fancy_h(x: torch.Tensor) -> torch.Tensor:
    """h2v1: each sample becomes two, 3/4 of it and 1/4 of its left or
    right neighbour (edges repeated), biases 1 and 2 (``jdsample.c``)."""
    left = torch.cat([x[:, :1], x[:, :-1]], 1)
    right = torch.cat([x[:, 1:], x[:, -1:]], 1)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    return torch.stack([even, odd], 2).flatten(1)


def _fancy_v(x: torch.Tensor) -> torch.Tensor:
    up = torch.cat([x[:1], x[:-1]], 0)
    down = torch.cat([x[1:], x[-1:]], 0)
    return torch.stack([(3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2], 1).flatten(0, 1)


def _fancy_hv(x: torch.Tensor) -> torch.Tensor:
    """h2v2: column sums 3 * nearer row + farther row, then 3 * nearer
    column sum + farther, biases 8 and 7, over 16."""
    up = torch.cat([x[:1], x[:-1]], 0)
    down = torch.cat([x[1:], x[-1:]], 0)
    out = []
    for cs in (3 * x + up, 3 * x + down):
        left = torch.cat([cs[:, :1], cs[:, :-1]], 1)
        right = torch.cat([cs[:, 1:], cs[:, -1:]], 1)
        out.append(torch.stack([(3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4],
                               2).flatten(1))
    return torch.stack(out, 1).flatten(0, 1)


def upsample_mode(c: Component, hmax: int, vmax: int) -> Tuple[int, int, bool]:
    """(horizontal ratio, vertical ratio, fancy) as ``jinit_upsampler``
    chooses: triangle filters for 2x1, 1x2 and 2x2 (2x1 and 2x2 only where
    the component is wider than 2 samples), sample repetition otherwise."""
    hr, vr = hmax // c.h, vmax // c.v
    fancy = (hr, vr) == (1, 2) or ((hr, vr) in ((2, 1), (2, 2)) and c.dw > 2)
    return hr, vr, fancy


def upsample_plain(plane: torch.Tensor, c: Component, hmax: int, vmax: int) -> torch.Tensor:
    """A component's (dh, dw) samples (int32) -> full resolution, before
    the crop to the image."""
    hr, vr, fancy = upsample_mode(c, hmax, vmax)
    if fancy:
        return {(2, 1): _fancy_h, (1, 2): _fancy_v, (2, 2): _fancy_hv}[(hr, vr)](plane)
    return plane.repeat_interleave(vr, 0).repeat_interleave(hr, 1)


def ycc_tables(device) -> Tuple[torch.Tensor, ...]:
    """``jdcolor.c``'s tables: Cr -> R, Cb -> B (rounded), and Cr -> G,
    Cb -> G (scaled by 2^16, ONE_HALF folded into the Cb one)."""
    x = torch.arange(256, dtype=torch.int64, device=device) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """An (H, W, ...) image turned as OpenCV turns it by its EXIF
    orientation (``ExifTransform``: flips and a transpose)."""
    if orientation == 1:
        return img
    if orientation in (5, 6, 7, 8):
        if orientation == 7:
            img = img.flip(0, 1)
        img = img.transpose(0, 1)
        if orientation == 6:
            img = img.flip(1)
        elif orientation == 8:
            img = img.flip(0)
        return img
    return img.flip({2: (1,), 3: (0, 1), 4: (0,)}[orientation])


def pixels_plain(coefs: torch.Tensor, quant: torch.Tensor, frame: Frame) -> torch.Tensor:
    """The plain pixel stage on the coefficients' device: (blocks, 64) int16
    and (ncomp, 64) int32 -> the oriented (H, W, 3) RGB uint8 image."""
    device = coefs.device
    hmax, vmax = frame.hmax, frame.vmax
    h, w = frame.height, frame.width
    at = frame.block_offsets()
    full = []
    for i, c in enumerate(frame.components):
        blocks = idct_plain(coefs[at[i] : at[i + 1]].reshape(c.bh, c.bw, 64), quant[i])
        plane = blocks.permute(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[: c.dh, : c.dw]
        full.append(upsample_plain(plane.to(torch.int64), c, hmax, vmax)[:h, :w])
    if frame.colour == GRAY:
        rgb = full[0].unsqueeze(-1).expand(h, w, 3)
    elif frame.colour == RGB:
        rgb = torch.stack(full, -1)
    else:
        y, cb, cr = full
        cr_r, cb_b, cr_g, cb_g = ycc_tables(device)
        rgb = torch.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], -1)
    return orient(rgb.clamp(0, 255).to(torch.uint8), frame.orientation).contiguous()
