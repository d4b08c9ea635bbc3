"""Filesystem IO: CSV <-> dict-of-lists, pickle, text, PNG and JPEG images.

Own copy of ``soft_contrastive_learning_tpu/utils/io.py`` (``load_csv``
with its header-only quirk, ``load_table``, ``save_csv``, ``load_txt``,
``save_txt``, ``{load,save}_pickle``, ``mkdir``). The CSV dict-of-lists
layout is the data pipeline's cross-stage contract: columns keyed by
header, every value kept as a string.

Images are read and written by the port's own codecs (no OpenCV or PIL, on
any host), to the pixels ``cv2.imread(IMREAD_COLOR)`` followed by BGR -> RGB
gives:

- ``load_img`` (a file) and ``decode_img`` (its bytes, as an HTTP upload
  brings them) tell PNG from JPEG by the signature, as OpenCV does, and
  return (H, W, 3) RGB uint8 numpy, turned by the file's EXIF orientation
  (a JPEG's APP1, a PNG's ``eXIf``). ``decode_imgs`` decodes a batch:
  ``prepare_img`` (a PNG decoded, a JPEG entropy-decoded, each on the
  caller's thread) then ``finish_imgs`` (the batch's JPEGs through one J1
  launch and one download on a CUDA device).
- PNG, decoded on the host with numpy and ``zlib``, every CRC checked: gray
  of 1-16 bits, RGB, gray + alpha and RGBA of 8 or 16 bits, palettes of
  1-8 bits, plain or Adam7-interlaced, any of the five row filters. Alpha
  and ``tRNS`` are dropped, gray is repeated over the three channels,
  16-bit samples keep their high byte, 1-4 bit gray is scaled to 8 bits.
  ``decode_gray`` reads a gray PNG as (H, W), as
  ``cv2.imdecode(IMREAD_GRAYSCALE)`` does.
- JPEG (``utils/jpeg.py``): decoded for a device, as ``utils/cv.py``'s ops
  are: on a CUDA device by the compiled entropy decoder and J1
  (``ops/kernels/jpeg.py``, on the decoder's own stream), on the CPU by
  the plain decoder and pixel stage; either way the numpy image comes back. What it refuses, and why,
  is in ``utils/jpeg.py``.
- ``save_img`` writes 8-bit RGB PNG, one filter for all rows (Sub by
  default) or one per row.

``TIMER`` (``core/logging.py::StepTimer``) spans a JPEG's host entropy
decode (``decode.entropy``, in ``prepare_img``) and a batch's pixel stage
(``decode.pixels``, in ``finish_imgs``: J1's staging, launch and the wait
for its download on a CUDA device).

Unpickling runs code: load only pickles this program or the JAX package
wrote.
"""

from __future__ import annotations

import csv
import os
import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from soft_contrastive_learning_torch.core.logging import StepTimer
from soft_contrastive_learning_torch.utils.jpeg import (
    Coefficients, decode_coefficients, exif_orientation, is_jpeg, orient)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)
# channels per PNG colour type: gray, RGB, palette index, gray + alpha, RGBA;
# and the bit depths each may have
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
TIMER = StepTimer()  # the codecs' spans


# ---------------------------------------------------------------- text
def load_txt(path: str) -> str:
    with open(path, "r") as f:
        return f.read()


def save_txt(text: str, path: str, mode: str = "w") -> None:
    with open(path, mode) as f:
        f.write(text)


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


# ---------------------------------------------------------------- pickle
def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


# ---------------------------------------------------------------- csv
def load_csv(
    path: str,
    delimiter: str = ",",
    has_header: bool = True,
    keys: Optional[Sequence[Any]] = None,
) -> Union[Dict[Any, List[str]], List[Any]]:
    """Read a CSV into a dict of column-name -> list-of-strings. A
    header-only file returns the key LIST, not an empty dict (the prep
    stages test for it); an empty file returns ``{}``."""
    with open(path, newline="") as f:
        rows = iter(csv.reader(f, delimiter=delimiter))
        try:
            first = next(rows)
        except StopIteration:
            return {}
        if has_header:
            cols: List[Any] = list(first)
        else:
            cols = list(keys) if keys and len(keys) == len(first) else list(range(len(first)))
        out: Dict[Any, List[str]] = {k: [] for k in cols}
        if not has_header:
            for k, v in zip(cols, first):
                out[k].append(v)
        for row in rows:
            for k, v in zip(cols, row):
                out[k].append(v)
        if any(len(v) > 0 for v in out.values()):
            return out
        return cols


def load_table(path: str, delimiter: str = ",", has_header: bool = True) -> Dict[Any, List[str]]:
    """``load_csv`` that always returns a dict: a header-only file gives its
    columns with empty lists."""
    out = load_csv(path, delimiter=delimiter, has_header=has_header)
    if isinstance(out, dict):
        return out
    return {k: [] for k in out}


def save_csv(data: Dict[Any, Any], path: str, delimiter: str = ",") -> None:
    """Write a dict of column -> list (or scalar) as CSV."""
    cols = list(data.keys())
    lines = [delimiter.join(f"{c}" for c in cols)]
    if cols and isinstance(data[cols[0]], (list, np.ndarray)):
        for i in range(len(data[cols[0]])):
            lines.append(delimiter.join(f"{data[c][i]}" for c in cols))
    elif cols:
        lines.append(delimiter.join(f"{data[c]}" for c in cols))
    save_txt("\n".join(lines), path)


# ---------------------------------------------------------------- PNG
def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise ValueError(f"{path}: PNG truncated in chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[crc_at : crc_at + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays: of a (left), b (up), c (up-left),
    the one nearest a + b - c, ties in that order."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(raw: np.ndarray, types: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Undo the Average and Paeth filters over a block of rows at once.

    ``raw`` (n, W, C) int16 filtered bytes, ``types`` (n,) their filters,
    ``prev`` (W, C) int16 the reconstructed row above the block (zeros at
    the image's top). Pixel (r, i) needs (r, i-1), (r-1, i) and (r-1, i-1),
    so the pixels of one anti-diagonal r + i = t are independent of each
    other. Row r is stored shifted right by r (``sk[r + 1, r + i + 2]``,
    the row above the block as row 0), so that diagonal t is one column
    ``t + 2`` and its neighbours are columns ``t + 1`` (left, and up in the
    row above) and ``t`` (up-left): n + W - 1 vectorized steps instead of
    n * W scalar ones."""
    n, w, ch = raw.shape
    sk = np.zeros((n + 1, n + w + 2, ch), np.int16)  # unwritten cells are the 0 border
    sk[0, 1 : w + 1] = prev
    fsk = np.zeros((n, n + w + 2, ch), np.int16)
    for r in range(n):
        fsk[r, r + 2 : r + 2 + w] = raw[r]
    paeth = (types == FILTER_PAETH)[:, None]
    all_paeth, no_paeth = paeth.all(), not paeth.any()
    for t in range(n + w - 1):
        r0, r1 = max(0, t - w + 1), min(n, t + 1)
        a = sk[r0 + 1 : r1 + 1, t + 1]  # (r, i - 1)
        b = sk[r0:r1, t + 1]  # (r - 1, i)
        c = sk[r0:r1, t]  # (r - 1, i - 1)
        if all_paeth:
            pred = _paeth(a, b, c)
        elif no_paeth:
            pred = (a + b) >> 1
        else:
            pred = np.where(paeth[r0:r1], _paeth(a, b, c), (a + b) >> 1)
        sk[r0 + 1 : r1 + 1, t + 2] = (fsk[r0:r1, t + 2] + pred) & 0xFF
    return np.stack([sk[r + 1, r + 2 : r + 2 + w] for r in range(n)])


def _unfilter(px: np.ndarray, types: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 filtered samples -> reconstructed samples. None and
    Sub rows depend on no other row: all of them at once (Sub: a running sum
    along the row, which wraps modulo 256 in uint8). A run of Up rows is a
    running sum down the run on top of the row above it. Each run of Average
    and Paeth rows goes through ``_unfilter_wavefront``. An image of Sub
    rows (what OpenCV and ``save_img`` write) is one ``cumsum``."""
    h = px.shape[0]
    out = np.empty_like(px)
    plain = types == FILTER_NONE
    out[plain] = px[plain]
    sub = types == FILTER_SUB
    if sub.all():
        return np.cumsum(px, axis=1, dtype=np.uint8)
    if sub.any():
        out[sub] = np.cumsum(px[sub], axis=1, dtype=np.uint8)
    r = 0
    while r < h:
        ft = types[r]
        if ft in (FILTER_NONE, FILTER_SUB):
            r += 1
            continue
        group = (FILTER_UP,) if ft == FILTER_UP else (FILTER_AVERAGE, FILTER_PAETH)
        e = r + 1
        while e < h and types[e] in group:
            e += 1
        prev = out[r - 1] if r else np.zeros_like(px[0])
        if ft == FILTER_UP:
            out[r:e] = np.cumsum(px[r:e], axis=0, dtype=np.uint8) + prev
        else:
            out[r:e] = _unfilter_wavefront(px[r:e].astype(np.int16), types[r:e],
                                           prev.astype(np.int16))
        r = e
    return out


# the file extensions an image directory is read for (JAX evaluation/parity.py's
# list); a file is decoded by its content, PNG or JPEG, whatever its name
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def load_img(path: str, device=None) -> np.ndarray:
    """Read a PNG or JPEG file as an (H, W, 3) RGB uint8 array
    (``decode_img``), as ``cv2.imread`` reads it: a JPEG that ends early
    reads to its end and the rest is grey."""
    with open(path, "rb") as f:
        return decode_img(f.read(), path, device, source="file")


def decode_img(data: bytes, path: str = "image", device=None,
               source: str = "buffer") -> np.ndarray:
    """Decode PNG or JPEG bytes, told apart by their signature as OpenCV
    does, as an (H, W, 3) RGB uint8 numpy array: what ``cv2.imread`` /
    ``cv2.imdecode(IMREAD_COLOR)`` and BGR -> RGB give, EXIF orientation
    applied. A JPEG is decoded for ``device`` (default the CPU): on a CUDA
    device by the compiled entropy decoder and J1
    (``ops/kernels/jpeg.py``), on the CPU by the plain decoder and pixel
    stage (``utils/jpeg.py``); a PNG on the host. ``path`` names the source
    in the reason a refused file is given. ``source`` says how a JPEG is
    read: ``"buffer"`` as ``cv2.imdecode`` reads bytes (data that ends
    before the decoder is done is refused, as OpenCV gives no image) or
    ``"file"`` as ``cv2.imread`` reads a file (``load_img``)."""
    return finish_imgs([prepare_img(data, path, device, source)], device)[0]


def decode_imgs(datas: Sequence[bytes], paths: Sequence[str], device=None,
                source: str = "buffer") -> List[np.ndarray]:
    """``decode_img`` of a batch: every image prepared first (a refused file
    raises, naming its path, before any launch), then the batch's JPEGs
    through one J1 launch and one download on a CUDA device."""
    return finish_imgs([prepare_img(d, p, device, source) for d, p in zip(datas, paths)],
                       device)


def prepare_img(data: bytes, path: str = "image", device=None, source: str = "buffer"):
    """The host's part of ``decode_img``: a PNG's pixels (numpy), or a
    JPEG's ``Coefficients`` (entropy-decoded for ``device``: the compiled
    decoder for a CUDA device, which runs without the GIL, the plain one for
    the CPU). Raises on a refused file."""
    if not is_jpeg(data):
        px, orientation = _decode_png(data, path)
        if px.shape[2] < 3:  # gray (+ alpha): the gray channel three times
            px = np.repeat(px[:, :, :1], 3, axis=2)
        return _oriented(px[:, :, :3], orientation)
    with TIMER.span("decode.entropy"):
        if torch.device("cpu" if device is None else device).type == "cuda":
            from soft_contrastive_learning_torch.ops.kernels.jpeg import entropy_decode

            return entropy_decode(data, path, source)
        return decode_coefficients(data, path, source)


def finish_imgs(prepared: Sequence, device=None) -> List[np.ndarray]:
    """``prepare_img``'s results -> (H, W, 3) RGB uint8 numpy images: the
    JPEGs' pixel stage on ``device`` (J1, one launch per chunk, and one
    download, on a CUDA device), the PNGs as they are."""
    jpegs = [i for i, p in enumerate(prepared) if isinstance(p, Coefficients)]
    out = list(prepared)
    if jpegs:
        from soft_contrastive_learning_torch.ops.kernels.jpeg import jpeg_pixels_host

        with TIMER.span("decode.pixels"):
            pixels = jpeg_pixels_host([prepared[i] for i in jpegs],
                                      torch.device("cpu" if device is None else device))
        for i, px in zip(jpegs, pixels):
            out[i] = px
    return out


def decode_gray(data: bytes, path: str = "image") -> np.ndarray:
    """Decode a gray PNG (a raw Bayer frame) as an (H, W) uint8 array, as
    ``cv2.imdecode(IMREAD_GRAYSCALE)`` reads one; a PNG with colour is
    refused (OpenCV would mix its channels to gray)."""
    px, orientation = _decode_png(data, path)
    if px.shape[2] != 1:
        raise ValueError(f"{path}: a PNG with {px.shape[2]} channels; a gray read takes gray "
                         "PNGs only")
    return _oriented(px[:, :, 0], orientation)


def _oriented(px: np.ndarray, orientation: int) -> np.ndarray:
    """A decoded PNG's samples, C-contiguous, turned by its ``eXIf``
    orientation (no torch op where there is none to apply)."""
    if orientation != 1:
        px = orient(torch.from_numpy(np.ascontiguousarray(px)), orientation).numpy()
    return np.ascontiguousarray(px)


def _unpack(data: bytes, h: int, w: int, depth: int, ch: int, path: str) -> np.ndarray:
    """One (sub-)image's filtered rows -> (h, w, ch) samples, unfiltered and
    unpacked: 16-bit samples kept as their high byte (libpng's strip_16, as
    OpenCV reads them), 1-, 2- and 4-bit samples as their values."""
    bits = w * ch * depth
    row = (bits + 7) // 8
    if len(data) < h * (1 + row):
        raise ValueError(f"{path}: PNG image data holds {len(data)} bytes, expected "
                         f"{h * (1 + row)} for {w}x{h}x{ch} at {depth} bits")
    rows = np.frombuffer(data, np.uint8, h * (1 + row)).reshape(h, 1 + row)
    types = rows[:, 0]
    if (types > FILTER_PAETH).any():
        raise ValueError(f"{path}: PNG row filter type {int(types.max())} does not exist")
    bpp = max(1, ch * depth // 8)  # the filters' byte distance
    raw = _unfilter(rows[:, 1:].reshape(h, row // bpp, bpp), types).reshape(h, row)
    if depth == 16:
        return np.ascontiguousarray(raw[:, 0::2]).reshape(h, w, ch)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        raw = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    return raw.reshape(h, w, ch)


def _decode_png(data: bytes, path: str):
    """PNG bytes -> ((H, W, channels) uint8 samples, EXIF orientation):
    palettes expanded to RGB (``tRNS`` dropped, indices past the palette
    black, as libpng), gray of 1, 2 or 4 bits scaled to 8, 16-bit samples
    reduced to their high byte, Adam7 passes put in place; the orientation
    of an ``eXIf`` chunk, 1 without one."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG or a JPEG file")
    header, idat, palette, orientation = None, [], None, 1
    for kind, body in _chunks(data, path):
        if header is None:
            if kind != b"IHDR" or len(body) != 13:
                raise ValueError(f"{path}: PNG does not start with an IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"eXIf" and orientation == 1:
            orientation = exif_orientation(body)
    w, h, depth, ctype, method, filter_method, interlace = header
    if ctype not in _DEPTHS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not a valid one")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not a valid one")
    if method or filter_method or interlace > 1:
        raise ValueError(f"{path}: unknown PNG compression, filter or interlace method "
                         f"({method}, {filter_method}, {interlace})")
    if ctype == 3 and (palette is None or len(palette) % 3 or not palette):
        raise ValueError(f"{path}: palette PNG without a valid PLTE chunk")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data does not inflate ({e})") from e
    if not interlace:
        px = _unpack(raw, h, w, depth, ch, path)
    else:
        px = np.zeros((h, w, ch), np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw == 0 or ph == 0:
                continue  # an empty pass has no rows
            size = ph * (1 + (pw * ch * depth + 7) // 8)
            px[y0::dy, x0::dx] = _unpack(raw[at : at + size], ph, pw, depth, ch, path)
            at += size
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
        table[: len(entries)] = entries
        return table[px[:, :, 0]], orientation
    if depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    return px, orientation


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def save_img(img: np.ndarray, path: str, filters: Union[int, Sequence[int]] = FILTER_SUB) -> None:
    """Write an (H, W, 3) RGB uint8 array (also (H, W) gray or (H, W, 4)
    RGBA) as a PNG file: ``filters`` is one filter type for every row or
    one per row. Filtering reads only the original pixels, so every filter
    is one vectorized pass."""
    if not str(path).lower().endswith(".png"):
        raise ValueError(f"{path}: the port writes PNG files only")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"save_img takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    types = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    if (types > FILTER_PAETH).any():
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(types.tolist()))}")
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    out = x.copy()
    for ft, pred in ((FILTER_SUB, lambda: a), (FILTER_UP, lambda: b),
                     (FILTER_AVERAGE, lambda: (a + b) >> 1),
                     (FILTER_PAETH, lambda: _paeth(a, b, c))):
        sel = types == ft
        if sel.any():
            out[sel] = x[sel] - pred()[sel]
    rows = np.concatenate([types[:, None], (out & 0xFF).astype(np.uint8).reshape(h, w * ch)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
