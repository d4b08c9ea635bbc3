"""Filesystem IO: CSV <-> dict-of-lists, pickle, text, PNG images.

Own copy of ``soft_contrastive_learning_tpu/utils/io.py`` (``load_csv``
with its header-only quirk, ``load_table``, ``save_csv``, ``load_txt``,
``save_txt``, ``{load,save}_pickle``, ``mkdir``). The CSV dict-of-lists
layout is the data pipeline's cross-stage contract: columns keyed by
header, every value kept as a string.

Images are PNG only, read and written by the port's own codec on numpy and
the standard library's ``zlib`` (no OpenCV or PIL, on any host):

- ``load_img`` takes 8-bit gray, gray + alpha, RGB and RGBA, not interlaced,
  with any of the five row filters, and returns RGB uint8 as
  ``cv2.imread(IMREAD_COLOR)`` followed by BGR -> RGB does: alpha dropped,
  gray repeated over the three channels. It checks every chunk's CRC and
  refuses, naming the reason, 16-bit samples, palettes, Adam7 interlacing
  and JPEG files.
- ``save_img`` writes 8-bit RGB, one filter for all rows (Sub by default)
  or one per row.

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

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)
# channels per PNG colour type (8 bits each): gray, RGB, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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


def load_img(path: str) -> np.ndarray:
    """Read a PNG file as an (H, W, 3) RGB uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: a JPEG file; the port decodes PNG only (it has no JPEG "
                         "decoder)")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if header is None:
            if kind != b"IHDR" or len(body) != 13:
                raise ValueError(f"{path}: PNG does not start with an IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, depth, ctype, method, filter_method, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: palette PNG (colour type 3); the port decodes 8-bit gray, "
                         "gray + alpha, RGB and RGBA only")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not a valid one")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG samples; the port decodes 8-bit samples only")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG; the port decodes non-interlaced PNG "
                         "only")
    if method or filter_method:
        raise ValueError(f"{path}: unknown PNG compression or filter method "
                         f"({method}, {filter_method})")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, expected "
                         f"{h * (1 + w * ch)} for {w}x{h}x{ch}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * ch)
    types = rows[:, 0]
    if (types > FILTER_PAETH).any():
        raise ValueError(f"{path}: PNG row filter type {int(types.max())} does not exist")
    px = _unfilter(rows[:, 1:].reshape(h, w, ch), types)
    if ch < 3:  # gray (+ alpha): the gray channel three times
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


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
