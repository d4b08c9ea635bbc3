"""JPEG decoding to OpenCV's bits: the parser, the plain entropy decoder and
the plain pixel stage.

``cv2.imread`` / ``cv2.imdecode(IMREAD_COLOR)`` decode a JPEG with the
libjpeg-turbo that OpenCV bundles, at libjpeg's defaults: the integer
``JDCT_ISLOW`` IDCT (``jidctint.c``), "fancy" triangular chroma upsampling
(``jdsample.c``), block smoothing of an incomplete progressive image
(``jdcoefct.c``), the fixed-point YCbCr -> RGB and YCCK -> CMYK of
``jdcolor.c`` and OpenCV's own CMYK -> BGR, and then OpenCV turns the image
by its EXIF orientation. All of it is exact integer arithmetic, so the port
reproduces it bit for bit in two stages:

* the entropy stage: markers, Huffman and arithmetic decoding of
  sequential and progressive scans with restart intervals -> each
  component's quantized coefficients as int16 ``(blocks_h, blocks_w, 64)``
  in natural order, its quantization table, and the frame's geometry, colour
  and smoothing state (``Coefficients``). ``decode_coefficients`` is the
  plain version in Python; the compiled one (host C++ in
  ``ops/kernels/csrc/jpeg.cu``, called by ``ops/kernels/jpeg.py``) gives the
  same arrays and releases the GIL;
* the pixel stage: block smoothing, dequantize, the islow IDCT, upsample,
  colour-convert, crop and orient -> (H, W, 3) RGB uint8. ``pixels_plain``
  is the plain version in integer torch ops on any device; J1
  (``ops/kernels/jpeg.py::jpeg_pixels_cuda``) is the hand kernel.

Two sources, as OpenCV's two readers have them: ``"file"`` (``imread``,
libjpeg's stdio source, which answers the end of the file with a fake EOI
marker, so a truncated file decodes with the rest grey) and ``"buffer"``
(``imdecode``, OpenCV's memory source, which suspends at the end of the
data, and OpenCV then returns no image: the port refuses). Corrupt data is
decoded as libjpeg-turbo decodes it: a bad Huffman code reads as 0, bytes
before a marker are skipped, a restart marker out of sequence is handled by
``jpeg_resync_to_restart``'s rules, entropy data that runs into a marker
reads zero bits and leaves the rest of its restart interval zero (grey), a
bogus progression only warns, a component no scan reaches is grey, and a
sequential scan that names Huffman table 0 or 1 where the file never
defined it gets the default tables of ITU T.81 K.3 (``jstdhuff.c``: MJPEG
frames carry none).

What is decoded: SOF0, SOF1, SOF2 (Huffman), SOF9 and SOF10 (arithmetic,
with DAC conditioning) frames at 8-bit precision with 1 (gray, returned as
three equal channels), 3 (YCbCr, or RGB where an Adobe APP14 marker or the
component ids say so) or 4 components (CMYK, or YCCK by the Adobe
transform), any integral sampling factors up to 4, restart intervals, and
the EXIF orientation of an APP1 segment (either byte order). Refused with a
``ValueError`` that names the file and the reason, exactly where OpenCV
returns no image: lossless (SOF3, SOF11) and hierarchical frames, 12- and
16-bit precision, 2 or more than 4 components, fractional sampling, an
undefined quantization table or Huffman table 2-3, a malformed marker
segment, and in buffer mode data that ends before the decoder is done.

A single-scan sequential file is complete after its scan (OpenCV reads no
further); a file of several scans is read to its EOI marker.

The IDCT's final range limit is a clamp to [0, 255], as in libjpeg-turbo's
SIMD code, which is what OpenCV runs on x86-64 (``jidctint.c``'s table
wraps values 512 or more away from the range instead; a valid file never
reaches them). Coefficients far outside the 11-bit range a DCT of 8-bit
samples gives overflow the SIMD code's 16-bit lanes; the port computes
them exactly and does not follow it there.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
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
GRAY, YCC, RGB, CMYK, YCCK = 0, 1, 2, 3, 4

FILE, BUFFER = "file", "buffer"

_SOF_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
# libjpeg-turbo 2.1+ smooths blocks by the DC and the first nine AC
# coefficients (jdcoefct.c SAVED_COEFS)
SMOOTHING_COEFS = 10
# the stdio source's answer to a read past the end of a file: a fake EOI,
# as many times as it is asked (more than one marker segment can read)
_EOF_FILL = b"\xff\xd9" * 32770
# zero bits past a segment's end for the rest of an MCU: ten blocks of 64
# coefficients of at most 32 bits each
_ZERO_TAIL = [0] * 4096

# ITU T.81 K.3 (libjpeg's jstdhuff.c): (counts of lengths 1-16, symbols) of
# DC table 0, DC table 1, AC table 0, AC table 1
_STD_HUFF = {
    (0, 0): (bytes.fromhex("00010501010101010100000000000000"), bytes(range(12))),
    (0, 1): (bytes.fromhex("00030101010101010101010000000000"), bytes(range(12))),
    (1, 0): (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
        "1718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a"
        "737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
        "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): (bytes.fromhex("00020102040403040705040400010277"), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e1"
        "25f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a"
        "737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7"
        "b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}

# ITU T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 |
# Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
# fixed probability bin (0.5, never moves)
_QE = [(0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
       (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
       (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
       (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
       (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
       (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
       (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
       (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
       (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
       (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
       (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
       (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
       (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
       (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
       (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
       (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
       (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
       (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
       (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
       (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
       (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
       (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
       (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
       (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
       (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
       (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
       (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
       (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
       (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]  # (Qe, Next_LPS, Next_MPS, Switch)
ARITAB = [qe << 16 | nmps << 8 | sw << 7 | nlps for qe, nlps, nmps, sw in _QE]
FIXED_BIN = 113
DC_STAT_BINS, AC_STAT_BINS = 64, 256


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
    """A frame's geometry, colour and smoothing state: what the pixel stage
    needs besides the coefficients."""

    height: int
    width: int
    colour: int  # GRAY, YCC, RGB, CMYK or YCCK
    orientation: int  # EXIF 1-8
    components: List[Component]
    # block smoothing (an incomplete progressive image), else None: the last
    # iMCU row whose scan data was whole, then per component the known bits
    # of zigzag coefficients 0-9 after the last scan, and the bits of 1-9
    # before it (index 0 unused), 21 values each (``smoothing_state``)
    smoothing: Optional[Tuple[int, ...]] = None

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)

    @property
    def imcu_rows(self) -> int:
        return -(-self.height // (8 * self.vmax))

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
    quant: np.ndarray  # (ncomp, 64) int32, natural order (zero for a component no scan reached)


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


# ---------------------------------------------------------------- tables
_DERIVED: Dict[Tuple[bytes, bytes], list] = {}


def _huffman_table(counts: bytes, symbols: bytes) -> Optional[list]:
    """A 16-bit lookup: entry ``(length << 8) | symbol`` for every 16-bit
    window that starts with the code, 0 where no code starts it; None for
    an over-subscribed table (``jpeg_make_d_derived_tbl`` refuses it)."""
    key = (bytes(counts), bytes(symbols))
    if key not in _DERIVED:
        lut = np.zeros(1 << 16, np.int32)
        code, k, ok = 0, 0, True
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= (1 << length):
                    ok = False
                    break
                lo = code << (16 - length)
                lut[lo : lo + (1 << (16 - length))] = (length << 8) | symbols[k]
                code += 1
                k += 1
            if not ok:
                break
            code <<= 1
        _DERIVED[key] = lut.tolist() if ok else None
    return _DERIVED[key]


# ---------------------------------------------------------------- bits
class _Bits:
    """A bit reader over one unstuffed segment (the entropy data up to a
    marker). Past its end it reads zeros, as libjpeg does once it has met
    the marker; ``p > nbits`` says bits past the end were used (libjpeg's
    ``insufficient_data``)."""

    __slots__ = ("win", "p", "nbits")

    def __init__(self, seg: bytes):
        a = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.uint32)
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist() + _ZERO_TAIL
        self.p = 0
        self.nbits = 8 * len(seg)


def _huff(bits: _Bits, lut: list) -> int:
    p = bits.p
    e = lut[(bits.win[p >> 3] << (p & 7)) >> 16 & 0xFFFF]
    if not e:  # a bad code: libjpeg reads 17 bits and fakes a zero
        bits.p = p + 17
        return 0
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


def _s16(v: int) -> int:
    """``v`` stored in a JCOEF (int16), as libjpeg stores the coefficients."""
    return ((v + 32768) & 0xFFFF) - 32768


# ---------------------------------------------------------------- Huffman MCUs
# Each decodes MCUs in turn until one reads past its segment (libjpeg then
# leaves the rest of the restart interval zero); returns how many it began.
def _baseline(bits, mcus, slot, dctabs, actabs, coefs, pred):
    win = bits.win
    nat = _NAT
    nbits = bits.nbits
    n = 0
    for blocks in mcus:
        n += 1
        for ci, b in blocks:
            k = slot[ci]
            out = coefs[ci]
            base = b * 64
            s = _huff(bits, dctabs[k])
            if s:
                pred[k] += _receive(bits, s)
            out[base] = pred[k]
            lut = actabs[k]
            i = 1
            p = bits.p
            while i < 64:
                e = lut[(win[p >> 3] << (p & 7)) >> 16 & 0xFFFF]
                if not e:
                    p += 17
                    break  # symbol 0: end of block
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
                    break
            bits.p = p
        if bits.p > nbits:
            break
    return n


def _dc_scan(bits, mcus, slot, dctabs, coefs, pred, ah, al):
    n = 0
    for blocks in mcus:
        n += 1
        for ci, b in blocks:
            out = coefs[ci]
            if ah == 0:
                k = slot[ci]
                s = _huff(bits, dctabs[k])
                if s:
                    pred[k] += _receive(bits, s)
                out[b * 64] = _s16(pred[k] << al)
            elif _get(bits, 1):
                out[b * 64] = _s16(out[b * 64] | 1 << al)
        if bits.p > bits.nbits:
            break
    return n


def _ac_first(bits, mcus, lut, coefs, ss, se, al):
    eobrun = 0
    nat = _NAT
    n = 0
    for blocks in mcus:
        n += 1
        if eobrun:
            eobrun -= 1
            continue
        ci, b = blocks[0]
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
        if bits.p > bits.nbits:
            break
    return n


def _ac_refine(bits, mcus, lut, coefs, ss, se, al):
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    nat = _NAT
    n = 0
    for blocks in mcus:
        n += 1
        ci, b = blocks[0]
        out = coefs[ci]
        base = b * 64
        i = ss
        if eobrun == 0:
            while i <= se:
                rs = _huff(bits, lut)
                r, s = rs >> 4, rs & 15
                if s:  # a size other than 1 only warns in libjpeg
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
        if bits.p > bits.nbits:
            break
    return n


# ---------------------------------------------------------------- arithmetic MCUs
class _Arith:
    """libjpeg's arithmetic decoder (``jdarith.c``, T.81 Annex D) over one
    unstuffed segment; past its end (a marker) it reads zero bytes."""

    __slots__ = ("seg", "i", "c", "a", "ct")

    def __init__(self, seg: bytes):
        self.seg = seg
        self.i = 0
        self.c = 0
        self.a = 0
        self.ct = -16  # two bytes are read before the first decision

    def decode(self, st: bytearray, at: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                i = self.i
                c = (c << 8) | (self.seg[i] if i < len(self.seg) else 0)
                self.i = i + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[at]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        nm = (qe >> 8) & 0xFF
        qe >>= 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional exchange: the MPS
                a = qe
                st[at] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[at] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[at] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[at] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _ArithState:
    """The statistics areas and predictions of an arithmetic scan's restart
    interval (libjpeg resets them at each restart)."""

    def __init__(self, ns: int):
        self.dc_stats: Dict[int, bytearray] = {}
        self.ac_stats: Dict[int, bytearray] = {}
        self.last_dc = [0] * ns
        self.dc_context = [0] * ns
        self.fixed = bytearray([FIXED_BIN])


def _arith_dc(dec: _Arith, state: _ArithState, k: int, tbl: int, cond: Tuple[int, int]):
    """One DC difference (Figures F.19-F.24), or None where its magnitude
    overflows (libjpeg gives up on the interval)."""
    st = state.dc_stats[tbl]
    s0 = state.dc_context[k]
    if dec.decode(st, s0) == 0:
        state.dc_context[k] = 0
        return 0
    sign = dec.decode(st, s0 + 1)
    at = s0 + 2 + sign
    m = dec.decode(st, at)
    if m:
        at = 20
        while dec.decode(st, at):
            m <<= 1
            if m == 0x8000:
                return None
            at += 1
    lo, hi = cond
    if m < (1 << lo) >> 1:
        state.dc_context[k] = 0
    elif m > (1 << hi) >> 1:
        state.dc_context[k] = 12 + sign * 4
    else:
        state.dc_context[k] = 4 + sign * 4
    v = m
    at += 14
    m >>= 1
    while m:
        if dec.decode(st, at):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac(dec: _Arith, st: bytearray, fixed: bytearray, out: list, base: int, ss: int,
              se: int, kk: int, al: int) -> bool:
    """The AC coefficients ``ss``-``se`` of a block (Figure F.20), scaled by
    ``al``; False where the data is bad (libjpeg gives up on the interval)."""
    nat = _NAT
    k = ss
    while k <= se:
        at = 3 * (k - 1)
        if dec.decode(st, at):
            break  # end of block
        while dec.decode(st, at + 1) == 0:
            at += 3
            k += 1
            if k > se:
                return False
        sign = dec.decode(fixed, 0)
        at += 2
        m = dec.decode(st, at)
        if m and dec.decode(st, at):
            m <<= 1
            at = 189 if k <= kk else 217
            while dec.decode(st, at):
                m <<= 1
                if m == 0x8000:
                    return False
                at += 1
        v = m
        at += 14
        m >>= 1
        while m:
            if dec.decode(st, at):
                v |= m
            m >>= 1
        v += 1
        out[base + nat[k]] = _s16((-v if sign else v) << al)
        k += 1
    return True


def _arith_ac_refine(dec: _Arith, st: bytearray, fixed: bytearray, out: list, base: int,
                     ss: int, se: int, al: int) -> bool:
    nat = _NAT
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not out[base + nat[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        at = 3 * (k - 1)
        if k > kex and dec.decode(st, at):
            break
        while True:
            idx = base + nat[k]
            c = out[idx]
            if c:
                if dec.decode(st, at + 2):
                    out[idx] = _s16(c + (m1 if c < 0 else p1))
                break
            if dec.decode(st, at + 1):
                out[idx] = m1 if dec.decode(fixed, 0) else p1
                break
            at += 3
            k += 1
            if k > se:
                return False
        k += 1
    return True


# ---------------------------------------------------------------- the walk
@dataclass
class _Scan:
    comps: List[int]  # indices into the frame's components
    td: List[int]  # DC table per scan component
    ta: List[int]  # AC table per scan component
    ss: int
    se: int
    ah: int
    al: int


class _Walk:
    """libjpeg-turbo's read of a JPEG as OpenCV drives it: the markers in
    turn (``jdmarker.c``), each scan decoded as it comes (``jdhuff.c``,
    ``jdphuff.c``, ``jdarith.c``), and the progression state the block
    smoothing reads (``jdcoefct.c``)."""

    def __init__(self, data: bytes, source: str, path: str):
        if source not in (FILE, BUFFER):
            raise ValueError(f"JPEG source {source!r}: 'file' or 'buffer'")
        self.path = path
        self.n = len(data)
        self.buffer = source == BUFFER
        self.d = data if self.buffer else data + _EOF_FILL
        self.height = self.width = 0
        self.progressive = self.arith = self.seen_sof = False
        self.components: List[Component] = []
        self.quant: Dict[int, np.ndarray] = {}
        self.latched: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, Tuple[bytes, bytes]] = {}
        self.ac: Dict[int, Tuple[bytes, bytes]] = {}
        self.cond_dc = [(0, 1)] * 16  # DAC: (L, U) per DC table
        self.cond_ac = [5] * 16  # DAC: K per AC table
        self.restart = 0
        self.scans = 0
        self.multi = True
        self.colour = YCC
        self.orientation = 1
        self.saw_jfif = self.saw_exif = False
        self.adobe: Optional[int] = None
        self.coefs: List[list] = []
        self.coef_bits = np.zeros((0, 64), np.int64)
        self.prev_bits = np.zeros((0, 10), np.int64)
        self.last_good = 0

    def fail(self, why: str):
        raise ValueError(f"{self.path}: {why}")

    def need(self, end: int) -> None:
        """Bytes up to ``end`` are read: past the data a buffer suspends
        (OpenCV gives no image)."""
        if end > self.n and (self.buffer or end > len(self.d)):
            self.fail("JPEG data ends before the decoder is done (truncated); decoded from "
                      "memory as cv2.imdecode does, which gives no image for it")

    def next_marker(self, pos: int) -> Tuple[int, int]:
        """libjpeg's next_marker: skip to 0xFF, any fill 0xFF, the code
        (FF 00 is data and skipped too); (code, position after it)."""
        d, end = self.d, len(self.d)
        while True:
            i = d.find(b"\xff", pos)
            if i < 0:
                self.need(end + 1)
            j = i + 1
            while j < end and d[j] == 0xFF:
                j += 1
            self.need(j + 1)
            if d[j]:
                return d[j], j + 1
            pos = j + 1

    def segment(self, pos: int) -> Tuple[bytes, int, int]:
        """The entropy data from ``pos`` to the next marker, unstuffed (any
        run of 0xFF then 0x00 is one 0xFF byte), the marker and the position
        after it; in buffer mode marker -1 where the data ends first."""
        d, end = self.d, len(self.d)
        out = bytearray()
        while True:
            i = d.find(b"\xff", pos)
            if i < 0:
                if self.buffer:
                    return bytes(out + d[pos:]), -1, end
                self.need(end + 1)
            out += d[pos:i]
            j = i + 1
            while j < end and d[j] == 0xFF:
                j += 1
            if j >= end:
                if self.buffer:
                    return bytes(out), -1, end
                self.need(j + 1)
            if d[j]:
                return bytes(out), d[j], j + 1
            out.append(0xFF)
            pos = j + 1

    def body(self, pos: int, code: int) -> bytes:
        self.need(pos + 2)
        length = self.d[pos] << 8 | self.d[pos + 1]
        if length < 2:
            self.fail(f"JPEG marker 0x{code:02X}'s segment has length {length} (corrupt)")
        self.need(pos + length)
        return self.d[pos + 2 : pos + length]

    def skip(self, pos: int) -> Tuple[bytes, int]:
        """A segment libjpeg skips or saves: its bytes and the position after
        it (a length below 2 reads as no bytes)."""
        self.need(pos + 2)
        length = self.d[pos] << 8 | self.d[pos + 1]
        if length <= 2:
            return b"", pos + 2
        self.need(pos + length)
        return self.d[pos + 2 : pos + length], pos + length

    # ---- the markers
    def run(self) -> None:
        code, pos = self.next_marker(2)
        while True:
            if code == 0xD9:
                if not self.scans:  # an EOI past the data is the stdio source's fake one
                    self.fail("JPEG ends before its first scan (truncated)" if pos > self.n
                              else "JPEG has no scan")
                return
            if code == 0xDA:
                code, pos = self.sos(pos)
                if code is None:
                    return  # one scan: the image is whole, OpenCV reads no further
                continue
            pos = self.marker_segment(code, pos)
            code, pos = self.next_marker(pos)

    def marker_segment(self, code: int, pos: int) -> int:
        if code in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            body = self.body(pos, code)
            if self.seen_sof:
                self.fail("JPEG has two frame headers (corrupt)")
            self.seen_sof = True
            self.sof(code, body)
            return pos + 2 + len(body)
        if code in _SOF_REFUSED:
            self.fail(f"{_SOF_REFUSED[code]} JPEG; OpenCV decodes baseline, extended and "
                      "progressive JPEG only")
        if code == 0xC4:
            body = self.body(pos, code)
            at = 0
            while len(body) - at > 16:
                index = body[at]
                counts = body[at + 1 : at + 17]
                total = sum(counts)
                at += 17
                if total > 256 or total > len(body) - at:
                    self.fail("JPEG DHT segment is malformed (corrupt)")
                tc, th = index & 0x10, index & ~0x10
                if th > 3:
                    self.fail(f"JPEG DHT defines table {th} (corrupt)")
                (self.ac if tc else self.dc)[th] = (counts, body[at : at + total])
                at += total
            if at != len(body):
                self.fail("JPEG DHT segment has the wrong length (corrupt)")
        elif code == 0xDB:
            body = self.body(pos, code)
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                if tq > 3 or at + 1 + size > len(body):
                    self.fail("JPEG DQT segment is malformed (corrupt)")
                raw = np.frombuffer(body[at + 1 : at + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = raw.astype(np.int32)
                self.quant[tq] = table
                at += 1 + size
        elif code == 0xDD:
            body = self.body(pos, code)
            if len(body) != 2:
                self.fail("JPEG DRI segment is malformed (corrupt)")
            self.restart = body[0] << 8 | body[1]
        elif code == 0xCC:
            body = self.body(pos, code)
            if len(body) % 2:
                self.fail("JPEG DAC segment has the wrong length (corrupt)")
            for at in range(0, len(body), 2):
                index, val = body[at], body[at + 1]
                if index >= 32:
                    self.fail(f"JPEG DAC defines table {index} (corrupt)")
                if index >= 16:
                    self.cond_ac[index - 16] = val
                elif val & 15 > val >> 4:
                    self.fail("JPEG DAC conditioning L > U (corrupt)")
                else:
                    self.cond_dc[index] = (val & 15, val >> 4)
        elif 0xE0 <= code <= 0xEF or code in (0xFE, 0xDC):
            body, after = self.skip(pos)
            if not self.scans:  # the colour and the Exif are settled at the first scan
                if code == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
                    self.saw_jfif = True
                elif code == 0xE1 and body[:6] == b"Exif\x00\x00" and not self.saw_exif:
                    self.saw_exif = True
                    self.orientation = exif_orientation(body[6:])
                elif code == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                    self.adobe = body[11]
            return after
        elif code == 0x01 or 0xD0 <= code <= 0xD7:
            return pos  # TEM, stray RSTn: no parameters
        elif code == 0xD8:
            self.fail("JPEG has a second SOI marker (corrupt)")
        else:
            self.fail(f"JPEG marker 0x{code:02X} is not supported (libjpeg refuses it)")
        return pos + 2 + len(body)

    def sof(self, code: int, body: bytes) -> None:
        if len(body) < 6:
            self.fail("JPEG frame header is short (corrupt)")
        precision, height, width, nc = struct.unpack(">BHHB", body[:6])
        if height == 0 or width == 0 or nc == 0:
            self.fail(f"JPEG frame of {width}x{height}, {nc} components (a DNL height, or "
                      "corrupt)")
        if len(body) != 6 + 3 * nc:
            self.fail("JPEG frame header has the wrong length (corrupt)")
        if precision != 8:
            self.fail(f"{precision}-bit JPEG; OpenCV decodes 8-bit samples only")
        if height > 65500 or width > 65500 or height * width > 1 << 30:
            self.fail(f"JPEG frame of {width}x{height} is larger than OpenCV reads")
        if nc not in (1, 3, 4):
            self.fail(f"{nc}-component JPEG; OpenCV decodes gray, 3- and 4-component JPEG only")
        self.height, self.width = height, width
        self.progressive, self.arith = code in (0xC2, 0xCA), code in (0xC9, 0xCA)
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i : 9 + 3 * i]
            ids = [c.cid for c in self.components]
            if cid in ids:  # libjpeg renames a repeated id
                cid = max(ids) + 1
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                self.fail(f"JPEG component sampling {h}x{v} (corrupt)")
            self.components.append(Component(cid, h, v, tq))
        hmax = max(c.h for c in self.components)
        vmax = max(c.v for c in self.components)
        for c in self.components:
            if hmax % c.h or vmax % c.v:
                self.fail(f"JPEG with fractional sampling ({c.h}x{c.v} against "
                          f"{hmax}x{vmax}); libjpeg refuses it too")
            c.dw = -(-width * c.h // hmax)
            c.dh = -(-height * c.v // vmax)
            if nc == 1:  # one component: a non-interleaved frame of its own blocks
                c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
            else:
                c.bw = -(-width // (8 * hmax)) * c.h
                c.bh = -(-height // (8 * vmax)) * c.v
        self.coefs = [[0] * (c.bw * c.bh * 64) for c in self.components]
        self.coef_bits = np.full((nc, 64), -1, np.int64)
        self.prev_bits = np.zeros((nc, 10), np.int64)

    def settle_colour(self) -> None:
        """``jdapimin.c`` default_decompress_parms, at the first scan."""
        nc = len(self.components)
        if nc == 1:
            self.colour = GRAY
        elif nc == 3:
            if self.saw_jfif:
                self.colour = YCC
            elif self.adobe is not None:
                self.colour = RGB if self.adobe == 0 else YCC
            else:
                ids = [c.cid for c in self.components]
                self.colour = RGB if ids == [82, 71, 66] else YCC  # 'R', 'G', 'B'
        else:
            self.colour = YCCK if self.adobe not in (None, 0) else CMYK

    # ---- a scan
    def sos(self, pos: int):
        body = self.body(pos, 0xDA)
        ns = body[0] if body else 0
        if len(body) != 4 + 2 * ns or not 1 <= ns <= 4:
            self.fail("JPEG scan header has the wrong length (corrupt)")
        if not self.seen_sof:
            self.fail("JPEG scan before its frame header (corrupt)")
        comps, td, ta = [], [], []
        ids = [c.cid for c in self.components]
        for i in range(ns):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            if cid in [ids[c] for c in comps]:  # libjpeg renames a repeated id
                cid = max(ids[c] for c in comps) + 1
            if cid not in ids:
                self.fail(f"JPEG scan names component {cid}, which the frame lacks (corrupt)")
            comps.append(ids.index(cid))
            td.append(t >> 4)
            ta.append(t & 15)
        ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
        scan = _Scan(comps, td, ta, ss, se, a >> 4, a & 15)
        if not self.scans:
            self.settle_colour()
            self.multi = self.progressive or ns < len(self.components)
        if ns > 1 and sum(self.components[c].h * self.components[c].v for c in comps) > 10:
            self.fail("JPEG MCU of more than 10 blocks (corrupt)")
        for ci in comps:
            if ci not in self.latched:
                tq = self.components[ci].tq
                if tq not in self.quant:
                    self.fail(f"JPEG component uses quantization table {tq}, which the file "
                              "does not define (corrupt)")
                self.latched[ci] = self.quant[tq].copy()
        if self.progressive:
            s = scan
            bad = (s.ss == 0 and s.se != 0) or (s.ss > 0 and (s.se < s.ss or s.se > 63 or ns != 1))
            if bad or (s.ah and s.al != s.ah - 1) or s.al > 13:
                self.fail(f"JPEG progressive scan parameters Ss={s.ss} Se={s.se} Ah={s.ah} "
                          f"Al={s.al} are invalid (corrupt)")
        else:  # libjpeg warns and decodes all 64 coefficients
            scan.ss, scan.se, scan.ah, scan.al = 0, 63, 0, 0
        self.scans += 1
        if self.progressive:  # coef_bits and their state before this scan; a bad order warns
            for ci in comps:
                if self.scans > 1:
                    self.prev_bits[ci, 1:] = self.coef_bits[ci, 1:10]
                else:
                    self.prev_bits[ci, 1:] = 0
                self.coef_bits[ci, scan.ss : scan.se + 1] = scan.al
        start = pos + 2 + len(body)
        marker, after = (self.arith_scan if self.arith else self.huffman_scan)(scan, start)
        if not self.multi:
            return None, None
        if marker < 0:
            self.need(self.n + 1)
        return marker, after

    def mcus(self, scan: _Scan) -> Tuple[list, list]:
        """Per MCU the (component index, flat block index) list, and its
        iMCU row."""
        comps = self.components
        if len(scan.comps) == 1:
            ci = scan.comps[0]
            c = comps[ci]
            bw, bh = -(-c.dw // 8), -(-c.dh // 8)
            return ([[(ci, r * c.bw + q)] for r in range(bh) for q in range(bw)],
                    [r // c.v for r in range(bh) for _ in range(bw)])
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        mx, my = -(-self.width // (8 * hmax)), -(-self.height // (8 * vmax))
        out = []
        for r in range(my):
            for q in range(mx):
                blocks = []
                for ci in scan.comps:
                    c = comps[ci]
                    for y in range(c.v):
                        for x in range(c.h):
                            blocks.append((ci, (r * c.v + y) * c.bw + q * c.h + x))
                out.append(blocks)
        return out, [r for r in range(my) for _ in range(mx)]

    def restart_marker(self, marker: int, after: int, expect: int) -> Tuple[bool, int, int]:
        """libjpeg's read_restart_marker at a restart: (swallowed, marker,
        position after it). A marker that is not RST``expect`` goes through
        jpeg_resync_to_restart: a marker below SOF0 or a RSTn one or two
        behind is skipped for the next; a non-RST marker or RSTn one or two
        ahead stays (the interval reads no data); any other RSTn is taken."""
        if marker < 0:
            self.need(self.n + 1)
        while marker != 0xD0 + expect:
            if marker < 0xC0:
                action = 2
            elif not 0xD0 <= marker <= 0xD7:
                action = 3
            elif marker - 0xD0 in ((expect + 1) & 7, (expect + 2) & 7):
                action = 3
            elif marker - 0xD0 in ((expect - 1) & 7, (expect - 2) & 7):
                action = 2
            else:
                action = 1
            if action == 1:
                break
            if action == 3:
                return False, marker, after
            marker, after = self.next_marker(after)
        return True, marker, after

    def huffman_scan(self, scan: _Scan, pos: int) -> Tuple[int, int]:
        """Decode one Huffman scan; returns the marker that ends it and the
        position after that marker."""
        dctabs, actabs = [], []
        for k in range(len(scan.comps)):
            dcneed = not self.progressive or (scan.ss == 0 and scan.ah == 0)
            acneed = not self.progressive or scan.ss > 0
            dctabs.append(self.table(0, scan.td[k]) if dcneed else None)
            actabs.append(self.table(1, scan.ta[k]) if acneed else None)
        mcus, rows = self.mcus(scan)
        n_mcu = len(mcus)
        per = self.restart or n_mcu
        slot = {ci: k for k, ci in enumerate(scan.comps)}
        seg_at = pos
        seg, marker, after = self.segment(pos)
        bits = _Bits(seg)
        insufficient = False
        last = begin = 0
        for iv, begin in enumerate(range(0, n_mcu, per)):
            if begin:
                ok, marker, after = self.restart_marker(marker, after, (iv - 1) & 7)
                if ok:
                    seg_at = after
                    seg, marker, after = self.segment(after)
                    bits = _Bits(seg)
                    insufficient = False
                else:
                    bits = _Bits(b"")
            if insufficient:
                continue
            todo = mcus[begin : begin + per]
            pred = [0] * len(scan.comps)
            if not self.progressive:
                done = _baseline(bits, todo, slot, dctabs, actabs, self.coefs, pred)
            elif scan.ss == 0:
                done = _dc_scan(bits, todo, slot, dctabs, self.coefs, pred, scan.ah, scan.al)
            elif scan.ah == 0:
                done = _ac_first(bits, todo, actabs[0], self.coefs, scan.ss, scan.se, scan.al)
            else:
                done = _ac_refine(bits, todo, actabs[0], self.coefs, scan.ss, scan.se, scan.al)
            last = begin + done - 1
            if bits.p > bits.nbits:
                if marker < 0:  # the reader ran into the end of the data
                    self.need(self.n + 1)
                insufficient = True
        if marker < 0 and not self.multi and _reads_past(
                self.d, seg_at, seg, mcus[begin:], slot, dctabs, actabs, not self.restart):
            self.need(self.n + 1)
        self.last_good = rows[last]
        return marker, after

    def table(self, ac: int, tid: int) -> list:
        """A scan's Huffman table, as jpeg_make_d_derived_tbl derives it at
        the scan's start: the file's, else in a sequential frame the default
        for ids 0-1 (``jdhuff.c`` installs them; ``jdphuff.c`` does not)."""
        if tid > 3:
            self.fail(f"JPEG scan names Huffman table {tid} (corrupt)")
        spec = (self.ac if ac else self.dc).get(tid)
        if spec is None and not self.progressive:
            spec = _STD_HUFF.get((ac, tid))
        if spec is None:
            self.fail(f"JPEG scan names {'AC' if ac else 'DC'} Huffman table {tid}, which the "
                      "file does not define (libjpeg has default tables 0-1 for sequential "
                      "frames only)")
        counts, symbols = spec
        if not ac and any(s > 15 for s in symbols):
            self.fail("JPEG DC Huffman table has a symbol above 15 (corrupt)")
        lut = _huffman_table(counts, symbols)
        if lut is None:
            self.fail("JPEG Huffman table is over-subscribed (corrupt)")
        return lut

    def arith_scan(self, scan: _Scan, pos: int) -> Tuple[int, int]:
        """Decode one arithmetic scan (``jdarith.c``)."""
        mcus, rows = self.mcus(scan)
        n_mcu = len(mcus)
        per = self.restart or n_mcu
        ns = len(scan.comps)
        dcneed = not self.progressive or (scan.ss == 0 and scan.ah == 0)
        acneed = not self.progressive or scan.ss > 0
        slot = {ci: k for k, ci in enumerate(scan.comps)}
        seg, marker, after = self.segment(pos)
        for iv, begin in enumerate(range(0, n_mcu, per)):
            if begin:
                ok, marker, after = self.restart_marker(marker, after, (iv - 1) & 7)
                if ok:
                    seg, marker, after = self.segment(after)
                else:
                    seg = b""
            state = _ArithState(ns)
            for k in range(ns):
                if dcneed:
                    state.dc_stats[scan.td[k]] = bytearray(DC_STAT_BINS)
                if acneed:
                    state.ac_stats[scan.ta[k]] = bytearray(AC_STAT_BINS)
            dec = _Arith(seg)
            for blocks in mcus[begin : begin + per]:
                if not self.mcu_arith(dec, state, scan, blocks, slot):
                    break
            if marker < 0 and dec.i > len(seg):  # read past the end of the data
                self.need(self.n + 1)
        self.last_good = rows[n_mcu - 1]
        return marker, after

    def mcu_arith(self, dec, state, scan, blocks, slot) -> bool:
        """One MCU of an arithmetic scan; False where the data is bad."""
        coefs = self.coefs
        for ci, b in blocks:
            k = slot[ci]
            out = coefs[ci]
            base = b * 64
            if not self.progressive or (scan.ss == 0 and scan.ah == 0):
                tbl = scan.td[k]
                diff = _arith_dc(dec, state, k, tbl, self.cond_dc[tbl])
                if diff is None:
                    return False
                state.last_dc[k] += diff
                out[base] = _s16(state.last_dc[k] << (scan.al if self.progressive else 0))
                if self.progressive:
                    continue
            elif scan.ss == 0:
                if dec.decode(state.fixed, 0):
                    out[base] = _s16(out[base] | 1 << scan.al)
                continue
            tbl = scan.ta[k]
            st = state.ac_stats[tbl]
            if not self.progressive:
                ok = _arith_ac(dec, st, state.fixed, out, base, 1, 63, self.cond_ac[tbl], 0)
            elif scan.ah == 0:
                ok = _arith_ac(dec, st, state.fixed, out, base, scan.ss, scan.se,
                               self.cond_ac[tbl], scan.al)
            else:
                ok = _arith_ac_refine(dec, st, state.fixed, out, base, scan.ss, scan.se, scan.al)
            if not ok:
                return False
        return True

    def smoothing_state(self) -> Optional[Tuple[int, ...]]:
        """``jdcoefct.c`` smoothing_ok: every component's table latched with
        its first ten entries non-zero, its DC known, and some component's
        first ten coefficients not all whole; then the state the smoothing
        reads (``Frame.smoothing``)."""
        if not self.progressive:
            return None
        useful = False
        for ci in range(len(self.components)):
            q = self.latched.get(ci)
            if q is None or (q[ZIGZAG[:SMOOTHING_COEFS]] == 0).any() or self.coef_bits[ci, 0] < 0:
                return None
            useful |= bool((self.coef_bits[ci, 1:SMOOTHING_COEFS] != 0).any())
        if not useful:
            return None
        out = [self.last_good]
        for ci in range(len(self.components)):
            prev = self.prev_bits[ci] if self.scans > 1 else np.full(10, -1, np.int64)
            out += self.coef_bits[ci, :SMOOTHING_COEFS].tolist() + [0] + prev[1:].tolist()
        return tuple(int(v) for v in out)


def _baseline_ops(seg: bytes, mcus, slot, dctabs, actabs) -> List[List[int]]:
    """The bit reads of sequential MCUs, per MCU: a Huffman code's length as
    itself, the value bits that follow as ``-bits``."""
    bits = _Bits(seg)
    out = []
    for blocks in mcus:
        ops = []
        for ci, _ in blocks:
            k = slot[ci]
            p = bits.p
            s = _huff(bits, dctabs[k])
            ops.append(bits.p - p)
            if s:
                ops.append(-s)
                bits.p += s
            i = 1
            while i < 64:
                p = bits.p
                rs = _huff(bits, actabs[k])
                ops.append(bits.p - p)
                r, s = rs >> 4, rs & 15
                if s:
                    ops.append(-s)
                    bits.p += s
                    i += r + 1
                elif r == 15:
                    i += 16
                else:
                    break
        out.append(ops)
    return out


def _reads_past(d: bytes, at: int, seg: bytes, mcus, slot, dctabs, actabs, fast: bool) -> bool:
    """Whether libjpeg-turbo's bit reader reads past the end of ``d`` while
    it decodes ``mcus``, the last restart interval of a one-scan file whose
    data (from ``at``) ends without a marker: in buffer mode that suspends
    and OpenCV gives no image, although every decoded bit lies in the data.
    Replays ``jdhuff.c``'s bit buffer on the interval's reads: the slow path
    (decode_mcu_slow) fills to 57 bits where a Huffman decode finds fewer
    than 8 bits or a read finds fewer than it needs; the fast path
    (decode_mcu_fast), taken while 512 bytes a block remain and no restart
    interval is set, reads 6 bytes where 16 bits or fewer are left."""
    n = len(d)
    ptr, left = at, 0

    def fill() -> bool:  # jpeg_fill_bit_buffer: False where it reads past the end
        nonlocal ptr, left
        while left < 57:
            if ptr >= n:
                return False
            c = d[ptr]
            ptr += 1
            if c == 0xFF:
                while True:
                    if ptr >= n:
                        return False
                    c = d[ptr]
                    ptr += 1
                    if c != 0xFF:
                        break
                if c:  # a marker: the data ends here (the segment has none)
                    left = 57
                    return True
            left += 8
        return True

    def fast_fill() -> None:
        nonlocal ptr, left
        if left <= 16:
            for _ in range(6):
                c0 = d[ptr]
                ptr += 1
                left += 8
                if c0 == 0xFF:
                    ptr += 1

    for blocks, ops in zip(mcus, _baseline_ops(seg, mcus, slot, dctabs, actabs)):
        if fast and n - ptr >= 512 * len(blocks):
            for op in ops:
                fast_fill()
                left -= abs(op)
            continue
        for op in ops:
            if op > 0:  # HUFF_DECODE: 8 bits of lookahead, then longer codes a bit at a time
                if left < 8 and not fill():
                    return True
                if op > 8:
                    if left < 9 and not fill():
                        return True
                    left -= 9
                    for _ in range(op - 9):
                        if left < 1 and not fill():
                            return True
                        left -= 1
                    continue
            elif left < -op and not fill():
                return True
            left -= abs(op)
    return False


def decode_coefficients(data: bytes, path: str = "image", source: str = BUFFER) -> Coefficients:
    """The plain entropy stage: JPEG bytes -> ``Coefficients``. ``source``
    is ``"file"`` (as ``cv2.imread`` reads a file: its end reads as an EOI
    marker) or ``"buffer"`` (as ``cv2.imdecode`` reads bytes: data that ends
    before the decoder is done is refused)."""
    if not is_jpeg(data):
        raise ValueError(f"{path}: not a JPEG file")
    walk = _Walk(data, source, path)
    walk.run()
    comps = walk.components
    flat = np.concatenate([np.asarray(c, np.int64) for c in walk.coefs]).astype(np.int16)
    zero = np.zeros(64, np.int32)
    quant = np.stack([walk.latched.get(ci, zero) for ci in range(len(comps))]).astype(np.int32)
    frame = Frame(walk.height, walk.width, walk.colour, walk.orientation, comps,
                  walk.smoothing_state())
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


# the natural positions of zigzag coefficients 1-9, and the table entries
# the smoothing reads (jdcoefct.c Q01_POS ... Q30_POS)
SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def smoothing_neighbours(c: Component, imcu_rows: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The blocks whose DC values ``jdcoefct.c``'s decompress_smooth_data
    reads for each block of component ``c``: per block row the rows of its
    5x5 window (-1: a row past the coefficient array, DC 0), per block
    column its columns. Rows follow libjpeg's image_block_row arithmetic
    (whose last iMCU row counts its rows as if every iMCU row had as many);
    columns follow its sliding registers, which repeat the edge block."""
    hib, wib, v = -(-c.dh // 8), -(-c.dw // 8), c.v
    last_rows = hib % v or v
    rows = []
    for r in range(c.bh):
        imcu, br = divmod(r, v)
        block_rows = last_rows if imcu == imcu_rows - 1 else v
        ibr, ibrs = imcu * block_rows + br, block_rows * imcu_rows
        prev = r - 1 if ibr > 0 else r
        pp = r - 2 if ibr > 1 else prev
        nxt = r + 1 if ibr < ibrs - 1 else r
        nn = r + 2 if ibr < ibrs - 2 else nxt
        rows.append([x if x < c.bh else -1 for x in (pp, prev, r, nxt, nn)])
    cols = [[min(max(b + k, 0), wib - 1) for k in (-2, -1, 0, 1, 2)] for b in range(c.bw)]
    return rows, cols


def _smooth_pred(num: torch.Tensor, q: torch.Tensor, al) -> torch.Tensor:
    """decompress_smooth_data's estimate of one coefficient from ``num``:
    rounded division by Q << 8, limited below 2^Al where Al > 0."""
    mag = (((q << 7) + num.abs()) // (q << 8))
    if al is not None:
        lim = (1 << al.clamp(min=0)) - 1
        mag = torch.where((al > 0) & (mag > lim), lim, mag)
    return torch.where(num >= 0, mag, -mag)


def smooth_plain(blocks: torch.Tensor, quant: torch.Tensor, c: Component, ci: int,
                 frame: Frame) -> torch.Tensor:
    """Block smoothing of an incomplete progressive image
    (``jdcoefct.c`` decompress_smooth_data, libjpeg-turbo 2.1+): (bh, bw, 64)
    int64 coefficients of component ``ci`` -> the coefficients its IDCT
    takes. Each of the first nine AC coefficients not known whole and still
    zero is estimated from the DC values of the 5x5 blocks around; where no
    AC bits are known at all the DC is re-estimated too. Rows after the last
    iMCU row whose data was whole use the bits known before the last scan."""
    st = frame.smoothing
    last_good = st[0]
    bits = torch.tensor(st[1 + 20 * ci : 21 + 20 * ci], dtype=torch.int64, device=blocks.device)
    rows, cols = smoothing_neighbours(c, frame.imcu_rows)
    dev = blocks.device
    rows_t = torch.tensor(rows, dtype=torch.int64, device=dev)  # (bh, 5)
    cols_t = torch.tensor(cols, dtype=torch.int64, device=dev)  # (bw, 5)
    dc = blocks[..., 0]
    dcz = torch.cat([dc, torch.zeros_like(dc[:1])], 0)  # row -1: zeros
    win = dcz[rows_t.clamp(max=c.bh)][:, :, cols_t]  # (bh, 5, bw, 5)
    win = torch.where((rows_t < 0)[:, :, None, None], 0, win)
    D = {5 * i + j + 1: win[:, i, :, j] for i in range(5) for j in range(5)}  # DC01..DC25
    imcu = torch.arange(c.bh, device=dev) // c.v
    use_prev = (imcu > last_good)[:, None]  # (bh, 1)
    kbits = [torch.where(use_prev, bits[10 + k], bits[k]) for k in range(10)]
    change_dc = torch.ones_like(use_prev)
    for k in range(1, 10):
        change_dc = change_dc & (kbits[k] == -1)
    q = quant.to(torch.int64)
    Q = {pos: q[pos] for pos in (0,) + SMOOTH_POS}
    q00 = Q[0]

    def pick(a, b):
        return torch.where(change_dc, a, b)

    num = {
        1: pick(-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10]
                - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17]
                - 13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25],
                -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]),
        8: pick(-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8]
                + 13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20]
                + D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25],
                -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]),
        16: pick(D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14]
                 + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23],
                 -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]),
        9: pick(-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25],
                D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4]
                - D[6] + 10 * D[7] - 10 * D[9]),
        2: pick(2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14]
                + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19],
                -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]),
        3: D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19],
        10: D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19],
        17: D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19],
        24: D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19],
    }
    out = blocks.clone()
    for k, pos in enumerate(SMOOTH_POS, start=1):
        al = kbits[k].expand(c.bh, c.bw)
        pred = _smooth_pred(q00 * num[pos], Q[pos], al)
        take = (al != 0) & (blocks[..., pos] == 0)
        if k > 5:
            take = take & change_dc
        out[..., pos] = torch.where(take, pred, blocks[..., pos])
    dc_num = q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6]
                    + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12]
                    + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18]
                    + 6 * D[19] - 6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24]
                    - 2 * D[25])
    out[..., 0] = torch.where(change_dc, _smooth_pred(dc_num, q00, None), blocks[..., 0])
    return ((out + 32768) & 0xFFFF) - 32768  # stored in a JCOEF


def idct_in_16_bit_lanes(coefs: torch.Tensor, quant: torch.Tensor, frame: Frame) -> bool:
    """Whether every block's IDCT stays in the range where libjpeg-turbo's
    SIMD islow IDCT (what OpenCV runs) is exact: dequantized coefficients
    and column-pass outputs within +-16383, so that its 16-bit lanes and
    the sums of two of them do not overflow. Outside it (only corrupt data
    or a broken table gets there) the port computes the IDCT exactly and
    parts from OpenCV: a recorded divergence."""
    at = frame.block_offsets()
    for i, c in enumerate(frame.components):
        blk = coefs[at[i] : at[i + 1]].reshape(c.bh, c.bw, 64).to(torch.int64)
        if frame.smoothing is not None:
            blk = smooth_plain(blk, quant[i], c, i, frame)
        x = blk * quant[i].to(torch.int64)
        if x.numel() and x.abs().max() > 16383:
            return False
        x = x.unflatten(-1, (8, 8))
        cols = _idct_1d([x[..., k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
        if x.numel() and max(int(t.abs().max()) for t in cols) > 16383:
            return False
    return True


def cmyk_to_rgb(c: torch.Tensor, m: torch.Tensor, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on libjpeg's (inverted, Adobe)
    CMYK samples, as RGB: each channel k - ((255 - x) * k >> 8)."""
    return torch.stack([k - (((255 - x) * k) >> 8) for x in (c, m, y)], -1)


def pixels_plain(coefs: torch.Tensor, quant: torch.Tensor, frame: Frame) -> torch.Tensor:
    """The plain pixel stage on the coefficients' device: (blocks, 64) int16
    and (ncomp, 64) int32 -> the oriented (H, W, 3) RGB uint8 image."""
    device = coefs.device
    hmax, vmax = frame.hmax, frame.vmax
    h, w = frame.height, frame.width
    at = frame.block_offsets()
    full = []
    for i, c in enumerate(frame.components):
        blk = coefs[at[i] : at[i + 1]].reshape(c.bh, c.bw, 64)
        if frame.smoothing is not None:
            blk = smooth_plain(blk.to(torch.int64), quant[i], c, i, frame)
        blocks = idct_plain(blk, quant[i])
        plane = blocks.permute(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[: c.dh, : c.dw]
        full.append(upsample_plain(plane.to(torch.int64), c, hmax, vmax)[:h, :w])
    if frame.colour == GRAY:
        rgb = full[0].unsqueeze(-1).expand(h, w, 3)
    elif frame.colour == RGB:
        rgb = torch.stack(full, -1)
    elif frame.colour == CMYK:
        rgb = cmyk_to_rgb(*full)
    else:
        y, cb, cr = full[:3]
        cr_r, cb_b, cr_g, cb_g = ycc_tables(device)
        g = (cb_g[cb] + cr_g[cr]) >> 16
        if frame.colour == YCC:
            rgb = torch.stack([y + cr_r[cr], y + g, y + cb_b[cb]], -1)
        else:  # YCCK -> CMYK (jdcolor.c ycck_cmyk_convert), then OpenCV's CMYK -> BGR
            cmy = [(255 - (y + t)).clamp(0, 255) for t in (cr_r[cr], g, cb_b[cb])]
            rgb = cmyk_to_rgb(*cmy, full[3])
    return orient(rgb.clamp(0, 255).to(torch.uint8), frame.orientation).contiguous()
