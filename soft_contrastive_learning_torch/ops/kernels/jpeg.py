"""J1: the JPEG pixel stage, a hand-written CUDA kernel for Hopper, and the
compiled entropy decoder beside it.

J1 replaces no ``pl.pallas_call`` site: it replaces libjpeg-turbo's host
block smoothing, IDCT, upsampling and colour conversion, which the JAX
package runs through ``cv2.imread`` / ``cv2.imdecode``. The source is
``csrc/jpeg.cu`` (its note gives the bound and the design): one launch
turns a batch of images of any size, sampling and colour transform (gray,
YCbCr, RGB, CMYK, YCCK) into their oriented RGB pixels. Its unit is a tile,
an iMCU row's span of at most 128 pixels of one image; ``plan_batch``
writes the table it reads (``IMAGE_DTYPE`` an image) and the tile prefix
that maps a CTA to its image and tile, and ``tile_plan`` is the kernel's
per-tile arithmetic in Python. The plain version is
``utils/jpeg.py::pixels_plain``: the wrappers' path for the CPU and what
``chip_smoke.py`` holds J1 to, bit for bit.

Entry points:

* ``jpeg_pixels_batch(coefficients, device)``: a list of ``Coefficients``
  (host arrays) -> a list of (H, W, 3) uint8 tensors on ``device``, views of
  one output buffer. On a CUDA device the batch is packed into the calling
  thread's pinned staging buffer (grown and reused; not overwritten before
  its last copy has completed), copied by one ``non_blocking`` copy and
  turned into pixels by one J1 launch, both on the decoder's own stream;
  the caller's stream waits on the launch's event. Threads share the
  stream and a lock held only to enqueue, so none waits on another's
  packing. A batch is
  split only where its coefficients pass ``CHUNK_BYTES``; one too small to
  fill the card's SMs with its tiles is cut into narrower tiles
  (``plan_batch``). On the CPU: ``pixels_plain`` per image.
* ``jpeg_pixels_host(coefficients, device)``: the same, as numpy arrays: on
  a CUDA device one download of the batch's output on the decoder's stream
  into the calling thread's pinned buffer, and the host waits on that
  stream's event alone (not on the model's).
* ``jpeg_pixels_cuda(coefs, quant, frame)``: one image whose coefficients
  and tables are tensors already on the card (a batch of one, launched on the
  current stream), the plain stage for CPU tensors.
* ``decode_jpeg(data, path, device, source)``: bytes -> a tensor on
  ``device`` (a batch of one).
* ``staged_launcher(coefficients, device)``: a batch staged once, launched
  again and again on the current stream (to time the kernel alone).

``jpeg_pixels_cuda.launches`` counts J1's launches, one per batch.

The host check: ``build_host_library`` compiles ``csrc/jpeg.cu`` with g++
(no CUDA: the entropy decoder and ``scl_jpeg_pixels_host``, which runs J1's
CTAs on the host, each step thread by thread in the kernel's order), and
``pixels_on_host`` runs a batch through it, plan and packing as on the card.
The CPU tests and ``scripts/jpeg_crosscheck.py`` hold it to the plain stage.

``entropy_decode`` is the compiled counterpart of
``utils/jpeg.py::decode_coefficients``: host C++ in the same library, called
through ctypes (which releases the GIL, so decode threads run it in
parallel), in either of OpenCV's modes (``source``: ``"file"`` as
``cv2.imread``, ``"buffer"`` as ``cv2.imdecode``). It gives the same
coefficient buffer and frame and refuses the same files with the same kind
of reason. It needs the library, so ``nvcc``: the port takes it where the
image is decoded for a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.utils.jpeg import (
    BUFFER, FILE, Coefficients, Component, Frame, decode_coefficients, pixels_plain,
    upsample_mode)

_MAX_COMPS = 4
_SMOOTH_WORDS = 20
_INFO_LEN = 6 + 8 * _MAX_COMPS + 2 + _SMOOTH_WORDS * _MAX_COMPS
_ERR_LEN = 512

# csrc/jpeg.cu's J1Comp and J1Image
COMP_DTYPE = np.dtype([(name, np.int32) for name in (
    "block0", "bw", "bh", "dw", "dh", "h", "v", "hr", "vr", "fancy")]
    + [("bits", np.int32, (_SMOOTH_WORDS,)), ("pad", np.int32, (2,))])
IMAGE_DTYPE = np.dtype([(name, np.int32) for name in (
    "ncomp", "colour", "orientation", "height", "width", "hmax", "vmax", "span", "spans",
    "imcu_rows", "smooth", "last_good", "quant0", "pad")]
    + [("coef0", np.int64), ("out0", np.int64), ("c", COMP_DTYPE, (_MAX_COMPS,))])
# csrc/jpeg.cu's CTA: its threads, the blocks whose coefficients it loads at
# once, the shared memory it needs before its image's late area (kSmLate),
# and the late area's least size (the IDCT's workspace and coefficient
# stage, kLateMin); a tile's widest span of pixels, and its narrowest, for
# a batch too small to fill the card
THREADS, STAGE = 256, 96
SMEM_FIXED = 1856 + 16 * STAGE
LATE_MIN = 36 * THREADS + 144 * STAGE
TILE_WIDTH, MIN_TILE_WIDTH = 128, 16
# a tile's phase clocks (csrc/jpeg.cu kClocks): its SM, the global timer
# (ns) at its start and end, the SM's clock (cycles) at its start and after
# each phase
CLOCKS = 8
PHASES = ("prologue", "blocks", "pixels", "store")
# a batch is split where its coefficients pass this many bytes, so that a
# chunk of large frames pins tens of MB and not a gigabyte
CHUNK_BYTES = 64 << 20


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("jpeg")
    _bind(lib)
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    """ctypes signatures of the library's entry points: the kernel's where it
    was built by nvcc, the host run of its CTAs where by g++."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_jpeg_info.argtypes = [p, ctypes.c_int64, i, p, p, i]
    lib.scl_jpeg_info.restype = i
    lib.scl_jpeg_entropy.argtypes = [p, ctypes.c_int64, i, p, p, p, p, i]
    lib.scl_jpeg_entropy.restype = i
    for name, extra in (("scl_jpeg_pixels", [p, p]), ("scl_jpeg_pixels_host", [])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p, p, i, i, p, p, p, i, i, *extra]
            getattr(lib, name).restype = i
    assert lib.scl_jpeg_info_len() == _INFO_LEN
    assert lib.scl_jpeg_image_bytes() == IMAGE_DTYPE.itemsize
    assert lib.scl_jpeg_smem_fixed() == SMEM_FIXED and lib.scl_jpeg_late_min() == LATE_MIN
    assert lib.scl_jpeg_threads() == THREADS


def _frame(info: np.ndarray) -> Frame:
    """``Frame`` from the decoder's info words (``csrc/jpeg.cu::write_info``)."""
    nc = int(info[2])
    comps = [Component(cid=int(k[0]), h=int(k[1]), v=int(k[2]), tq=int(k[3]), dw=int(k[4]),
                       dh=int(k[5]), bw=int(k[6]), bh=int(k[7]))
             for k in info[6 : 6 + 8 * nc].reshape(-1, 8)]
    sm = info[6 + 8 * _MAX_COMPS :]
    smoothing = (tuple(int(v) for v in sm[1 : 2 + _SMOOTH_WORDS * nc]) if sm[0] else None)
    return Frame(int(info[0]), int(info[1]), int(info[3]), int(info[4]), comps, smoothing)


def entropy_decode(data: bytes, path: str = "image", source: str = BUFFER) -> Coefficients:
    """JPEG bytes -> ``Coefficients`` by the compiled decoder, read as
    ``source`` says (``"file"`` or ``"buffer"``, as
    ``utils/jpeg.py::decode_coefficients``); raises ``ValueError`` naming
    ``path`` and the reason for a refused file."""
    if source not in (FILE, BUFFER):
        raise ValueError(f"JPEG source {source!r}: 'file' or 'buffer'")
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    mode = int(source == BUFFER)
    info = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.scl_jpeg_info(buf.ctypes.data, len(buf), mode, info.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    frame = _frame(info)
    coefs = np.zeros((frame.block_offsets()[-1], 64), np.int16)
    quant = np.zeros((len(frame.components), 64), np.int32)
    if lib.scl_jpeg_entropy(buf.ctypes.data, len(buf), mode, coefs.ctypes.data,
                            quant.ctypes.data, info.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return Coefficients(_frame(info), coefs, quant)


# ------------------------------------------------------------------ the plan
def _align16(n: int) -> int:
    return (n + 15) & ~15


class BatchPlan:
    """What J1 reads for a batch besides the coefficients and tables: the
    table (``IMAGE_DTYPE`` per image), the tile prefix (image i owns CTAs
    ``prefix[i]`` to ``prefix[i + 1] - 1``), the launch's dynamic shared
    memory, whether any image is smoothed, and each image's output (byte
    offset, shape) in the batch's output buffer of ``out_bytes``."""

    def __init__(self, table, prefix, smem, smooth, outputs, out_bytes):
        self.table, self.prefix, self.smem, self.smooth = table, prefix, smem, smooth
        self.outputs, self.out_bytes = outputs, out_bytes

    @property
    def tiles(self) -> int:
        return int(self.prefix[-1])


@functools.lru_cache(maxsize=512)
def _entry(key: tuple, tile_width: int) -> Tuple[np.ndarray, int, int]:
    """A frame's table entry with its offsets zero (``IMAGE_DTYPE`` as int32
    words), its tiles and the shared memory a CTA of it needs, at tiles of
    as many MCU columns as ``tile_width`` pixels hold (at least one);
    ``key`` is ``_key(frame)``."""
    height, width, colour, orientation, smoothing, comps = key
    nc = len(comps)
    hmax, vmax = max(c[0] for c in comps), max(c[1] for c in comps)
    if nc not in (1, 3, 4) or hmax > 4 or vmax > 4:
        raise ValueError(f"J1: a frame of {nc} components sampled up to {hmax}x{vmax}")
    span = max(tile_width // (8 * hmax), 1)
    spans = -(-(-(-width // (8 * hmax))) // span)
    th, tw = 8 * vmax, 8 * hmax * span
    imcu_rows = -(-height // (8 * vmax))
    entry = np.zeros((), IMAGE_DTYPE)
    region = dc = block0 = 0
    for k, (h, v, dw, dh, bw, bh) in enumerate(comps):
        hr, vr, fancy = upsample_mode(Component(0, h, v, 0, dw, dh, bw, bh), hmax, vmax)
        fv, fh = int(fancy and vr == 2), int(fancy and hr == 2)
        c = entry["c"][k]
        c["block0"], c["bw"], c["bh"], c["dw"], c["dh"] = block0, bw, bh, dw, dh
        c["h"], c["v"], c["hr"], c["vr"], c["fancy"] = h, v, hr, vr, fancy
        if smoothing:
            c["bits"] = smoothing[1 + _SMOOTH_WORDS * k : 1 + _SMOOTH_WORDS * (k + 1)]
            dc += (v + 2 * fv + 4) * (span * h + 2 * fh + 4)
        region += (8 * v + 2) * (8 * span * h + 16)
        block0 += bw * bh
    for name, value in (("ncomp", nc), ("colour", colour), ("orientation", orientation),
                        ("height", height), ("width", width), ("hmax", hmax), ("vmax", vmax),
                        ("span", span), ("spans", spans), ("imcu_rows", imcu_rows),
                        ("smooth", smoothing is not None),
                        ("last_good", smoothing[0] if smoothing else 0)):
        entry[name] = value
    staging = tw * ((3 * th + 30) & ~15) if orientation >= 5 else th * ((3 * tw + 30) & ~15)
    smem = SMEM_FIXED + max(LATE_MIN, _align16(staging)) + region + 4 * dc
    return entry.reshape(1).view(np.int32), imcu_rows * spans, smem


def _key(f: Frame) -> tuple:
    return (f.height, f.width, f.colour, f.orientation, f.smoothing,
            tuple((c.h, c.v, c.dw, c.dh, c.bw, c.bh) for c in f.components))


def plan_batch(frames: Sequence[Frame], fill: int = 0) -> BatchPlan:
    """J1's table for ``frames``: each image's blocks, tables and output
    (16-byte aligned) after the one before's in the batch's buffers. A tile
    is one iMCU row (8 x vmax rows) by as many MCU columns as
    ``TILE_WIDTH`` pixels hold; where that gives the batch fewer than
    ``fill`` tiles (the card's SMs), as half as many pixels hold, down to
    ``MIN_TILE_WIDTH``: a batch too small to fill the card then runs more,
    shorter tiles at once. Raises on a frame the kernel does not take.
    Frames of one geometry share a cached entry."""
    n = len(frames)
    keys = [_key(f) for f in frames]
    width = TILE_WIDTH
    while width > MIN_TILE_WIDTH and sum(_entry(k, width)[1] for k in keys) < fill:
        width //= 2
    table = np.empty(n, IMAGE_DTYPE)
    words = table.view(np.int32).reshape(n, -1)
    tiles = np.zeros(n + 1, np.int64)
    sizes = np.zeros(n, np.int64)
    smem, smooth, outputs = SMEM_FIXED, False, []
    for i, f in enumerate(frames):
        entry, tiles[i + 1], need = _entry(keys[i], width)
        words[i] = entry
        smem, smooth = max(smem, need), smooth or f.smoothing is not None
        shape = (*f.output_shape(), 3)
        outputs.append(shape)
        sizes[i] = _align16(shape[0] * shape[1] * 3)
    out0 = np.concatenate([[0], np.cumsum(sizes)])
    table["out0"] = out0[:-1]
    table["coef0"] = np.cumsum([0] + [f.block_offsets()[-1] for f in frames[:-1]])
    table["quant0"] = np.cumsum([0] + [len(f.components) for f in frames[:-1]])
    return BatchPlan(table, np.cumsum(tiles).astype(np.int32), smem, smooth,
                     [(int(a), s) for a, s in zip(out0[:-1], outputs)], int(out0[-1]))


def tile_plan(entry, tile: int) -> Tuple[Tuple[int, int, int, int], list]:
    """Tile ``tile`` of a table entry, as the kernel computes it
    (``csrc/jpeg.cu`` tile_rect, tile_plan): its pixels in the decoded image
    (first row, first column, rows, columns) and per component (by0, bx0,
    by_lo, by_hi, bx_lo, bx_hi): its own first block row and column and the
    blocks it transforms, the upsampling's halo included."""
    spans, span, hmax, vmax = (int(entry[k]) for k in ("spans", "span", "hmax", "vmax"))
    iy, sp = divmod(tile, spans)
    r0, c0 = iy * 8 * vmax, sp * span * 8 * hmax
    rect = (r0, c0, min(8 * vmax, int(entry["height"]) - r0),
            min(8 * hmax * span, int(entry["width"]) - c0))
    comps = []
    for c in entry["c"][: int(entry["ncomp"])]:
        fv = int(bool(c["fancy"]) and c["vr"] == 2)
        fh = int(bool(c["fancy"]) and c["hr"] == 2)
        by0, bx0 = iy * int(c["v"]), sp * span * int(c["h"])
        comps.append((by0, bx0, max(by0 - fv, 0), min(by0 + int(c["v"]) + fv, int(c["bh"])),
                      max(bx0 - fh, 0), min(bx0 + span * int(c["h"]) + fh, int(c["bw"]))))
    return rect, comps


def build_host_library(out_dir) -> ctypes.CDLL:
    """``csrc/jpeg.cu`` built by g++ into ``out_dir``, loaded and bound: the
    entropy decoder and ``scl_jpeg_pixels_host`` (module docstring)."""
    src = Path(out_dir) / "jpeg_host.cpp"
    src.write_text(f'#include "{_build.SRC_DIR / "jpeg.cu"}"\n')
    lib = Path(out_dir) / "libjpeg_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-fno-strict-aliasing",
                    "-o", str(lib), str(src)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    _bind(dll)
    return dll


def pixels_on_host(lib: ctypes.CDLL, batch: Sequence[Coefficients],
                   fill: int = 0) -> List[np.ndarray]:
    """A batch through J1's CTAs run on the host by ``lib`` (a
    ``build_host_library``): the card's plan (``fill`` as ``plan_batch``
    takes it: the card's SMs), packing and output layout."""
    plan = plan_batch([co.frame for co in batch], fill)
    coefs = np.ascontiguousarray(np.concatenate([co.coefs for co in batch]))
    quant = np.ascontiguousarray(np.concatenate([co.quant for co in batch]))
    out = np.zeros(max(plan.out_bytes, 16), np.uint8)
    lib.scl_jpeg_pixels_host(plan.table.ctypes.data, plan.prefix.ctypes.data, len(batch),
                             plan.tiles, coefs.ctypes.data, quant.ctypes.data, out.ctypes.data,
                             plan.smem, int(plan.smooth))
    return [out[at : at + shape[0] * shape[1] * 3].reshape(shape) for at, shape in plan.outputs]


# ------------------------------------------------------------------ the decoder
class _Decoder:
    """J1 on one CUDA device: its stream and the device's SM count (the
    tiles that fill it), and for each thread that calls it a pinned staging
    buffer (grown, reused once its last copy has completed) and a pinned
    download buffer. A thread packs into and waits on its own buffers
    outside the lock; the lock is held only to enqueue a copy, a launch or a
    download (8 decode threads calling the CUDA runtime at once decoded
    fewer images a second than with it: ``PERF.md``, J1's row)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.lock = threading.Lock()
        self._local = threading.local()

    @staticmethod
    def _grow(buf, n: int):
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 2 * (0 if buf is None else buf.numel())), dtype=torch.uint8,
                              pin_memory=True)
        return buf

    def stage(self, sections: Sequence[Sequence[np.ndarray]], stream) -> Tuple[torch.Tensor, list]:
        """Each section's arrays, one after another, 16-byte aligned sections
        in the calling thread's pinned buffer (once its last copy has
        completed), then one ``non_blocking`` copy to a fresh device buffer
        on ``stream``. Returns the device buffer and each section's byte
        offset in it."""
        offsets, total = [], 0
        for arrays in sections:
            offsets.append(total)
            total = _align16(total + sum(a.nbytes for a in arrays))
        local = self._local
        if getattr(local, "copied", None) is not None:
            local.copied.synchronize()
        local.pinned = self._grow(getattr(local, "pinned", None), total)
        host = local.pinned.numpy()
        for at, arrays in zip(offsets, sections):
            for a in arrays:
                host[at : at + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                at += a.nbytes
        local.copied = torch.cuda.Event()
        with self.lock, torch.cuda.stream(stream):
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(local.pinned[:total], non_blocking=True)
            local.copied.record(stream)
        return dev, offsets

    def launch(self, plan: BatchPlan, tables, coefs, quant, out, stream, clocks=None) -> None:
        """One J1 launch on ``stream``, on the decoder's device whichever is
        the calling thread's current one (the table and prefix at
        ``tables``'s two offsets; coefficient, table and output pointers;
        ``clocks``: None, or an int64 tensor of ``CLOCKS`` words a tile for
        the phase clocks)."""
        lib = _lib()
        with self.lock, torch.cuda.device(self.device):
            err = lib.scl_jpeg_pixels(
                tables[0], tables[1], len(plan.outputs), plan.tiles, coefs, quant, out,
                plan.smem, int(plan.smooth), None if clocks is None else clocks.data_ptr(),
                stream.cuda_stream)
        _build.check(lib, err, "J1")
        _build.count_launch(jpeg_pixels_cuda)

    def pixels(self, batch: Sequence[Coefficients]) -> Tuple[BatchPlan, torch.Tensor]:
        """The batch's output buffer on the card and its plan, launched on the
        decoder's stream."""
        plan = plan_batch([co.frame for co in batch], self.sms)
        dev, at = self.stage([[plan.table], [plan.prefix], [co.quant for co in batch],
                              [co.coefs for co in batch]], self.stream)
        with torch.cuda.stream(self.stream):
            out = torch.empty(max(plan.out_bytes, 16), dtype=torch.uint8, device=self.device)
        base = dev.data_ptr()
        self.launch(plan, (base + at[0], base + at[1]), base + at[3], base + at[2],
                    out.data_ptr(), self.stream)
        return plan, out

    def download(self, out: torch.Tensor, n: int) -> Tuple[np.ndarray, torch.cuda.Event]:
        """``out``'s first n bytes queued for the host on the decoder's
        stream, into the calling thread's own pinned buffer; the caller
        waits on the returned event."""
        down = self._grow(getattr(self._local, "down", None), n)
        self._local.down = down
        done = torch.cuda.Event()
        with self.lock, torch.cuda.stream(self.stream):
            down[:n].copy_(out[:n], non_blocking=True)
            done.record(self.stream)
        return down.numpy(), done


_decoders: Dict[torch.device, _Decoder] = {}
_decoders_lock = threading.Lock()


def _decoder(device) -> _Decoder:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _decoders_lock:
        if device not in _decoders:
            _decoders[device] = _Decoder(device)
        return _decoders[device]


def _chunks(batch: Sequence[Coefficients]) -> List[Sequence[Coefficients]]:
    """The batch cut where its coefficients pass ``CHUNK_BYTES``."""
    out, start, size = [], 0, 0
    for i, co in enumerate(batch):
        if i > start and size + co.coefs.nbytes > CHUNK_BYTES:
            out.append(batch[start:i])
            start, size = i, 0
        size += co.coefs.nbytes
    if start < len(batch):
        out.append(batch[start:])
    return out


def _plain(co: Coefficients) -> torch.Tensor:
    return pixels_plain(torch.from_numpy(co.coefs), torch.from_numpy(co.quant), co.frame)


def jpeg_pixels_batch(batch: Sequence[Coefficients], device) -> List[torch.Tensor]:
    """The pixel stage of a batch: ``Coefficients`` -> each image's oriented
    (H, W, 3) RGB uint8 tensor on ``device``. On a CUDA device one J1 launch
    per chunk (module docstring), the images views of its output buffer, the
    current stream made to wait on the launch; on the CPU ``pixels_plain``."""
    device = torch.device(device)
    if device.type == "cpu":
        return [_plain(co) for co in batch]
    if device.type != "cuda":
        raise ValueError(f"jpeg_pixels_batch: device {device}")
    dec = _decoder(device)
    images = []
    for chunk in _chunks(batch):
        plan, out = dec.pixels(chunk)
        done = torch.cuda.Event()
        done.record(dec.stream)
        current = torch.cuda.current_stream(dec.device)
        current.wait_event(done)
        out.record_stream(current)
        images += [out[at : at + shape[0] * shape[1] * 3].view(shape)
                   for at, shape in plan.outputs]
    return images


def jpeg_pixels_host(batch: Sequence[Coefficients], device) -> List[np.ndarray]:
    """``jpeg_pixels_batch`` as numpy arrays: on a CUDA device one launch and
    one download per chunk, the host waiting on the decoder's stream alone."""
    device = torch.device(device)
    if device.type == "cpu":
        return [_plain(co).numpy() for co in batch]
    if device.type != "cuda":
        raise ValueError(f"jpeg_pixels_host: device {device}")
    dec = _decoder(device)
    images = []
    for chunk in _chunks(batch):
        plan, out = dec.pixels(chunk)
        host, done = dec.download(out, plan.out_bytes)
        done.synchronize()
        images += [host[at : at + shape[0] * shape[1] * 3].reshape(shape).copy()
                   for at, shape in plan.outputs]
    return images


def staged_launcher(batch: Sequence[Coefficients], device, clocks: torch.Tensor | None = None):
    """For timing J1 alone: ``batch`` planned and copied to the CUDA
    ``device`` once; returns a function that launches J1 on it on the
    current stream (one launch a call, counted) and returns the output
    buffer (image i at ``plan.outputs[i]``; the plan is ``.plan``). With
    ``clocks`` (int64, ``CLOCKS`` words a tile, on the device) each launch
    writes its tiles' phase clocks there (``phase_clocks`` reads them)."""
    dec = _decoder(device)
    stream = torch.cuda.current_stream(dec.device)
    plan = plan_batch([co.frame for co in batch], dec.sms)
    dev, at = dec.stage([[plan.table], [plan.prefix], [co.quant for co in batch],
                         [co.coefs for co in batch]], stream)
    out = torch.empty(max(plan.out_bytes, 16), dtype=torch.uint8, device=dec.device)
    base = dev.data_ptr()

    def launch() -> torch.Tensor:
        dec.launch(plan, (base + at[0], base + at[1]), base + at[3], base + at[2],
                   out.data_ptr(), torch.cuda.current_stream(dec.device), clocks)
        return out

    launch.plan, launch.buffers = plan, (dev, out)
    return launch


def phase_clocks(clocks: torch.Tensor, tiles: int) -> dict:
    """A profiled launch's clocks (``staged_launcher(..., clocks=)``) ->
    the mean cycles a tile spends in each of ``PHASES``, the launch's span
    (ns) from the first tile's start to the last tile's end, the tiles' mean
    time (ns), and the most tiles one SM ran."""
    c = clocks[: CLOCKS * tiles].view(tiles, CLOCKS).cpu().numpy().astype(np.int64)
    out = {name: float(np.mean(c[:, i + 4] - c[:, i + 3])) for i, name in enumerate(PHASES)}
    out.update(span_ns=float(c[:, 2].max() - c[:, 1].min()), tile_ns=float(np.mean(c[:, 2] - c[:, 1])),
               tiles_per_sm=int(np.bincount(c[:, 0]).max()))
    return out


def jpeg_pixels_cuda(coefs: torch.Tensor, quant: torch.Tensor, frame: Frame) -> torch.Tensor:
    """The pixel stage of one image through J1 for CUDA tensors (a batch of
    one on the current stream), the plain version for CPU tensors: (blocks,
    64) int16 coefficients in natural order and (ncomp, 64) int32 tables ->
    the oriented (H, W, 3) RGB uint8 image on their device. Raises on
    anything the kernel does not take."""
    if coefs.device.type == "cpu":
        return pixels_plain(coefs, quant, frame)
    if coefs.device.type != "cuda" or quant.device != coefs.device:
        raise ValueError(f"jpeg_pixels_cuda: coefficients on {coefs.device}, tables on "
                         f"{quant.device}")
    if coefs.dtype != torch.int16 or quant.dtype != torch.int32:
        raise TypeError("J1 takes int16 coefficients and int32 tables")
    nc = len(frame.components)
    blocks = frame.block_offsets()[-1]
    if coefs.shape != (blocks, 64) or quant.shape != (nc, 64) or nc not in (1, 3, 4):
        raise ValueError(f"J1: coefficients {tuple(coefs.shape)} and tables "
                         f"{tuple(quant.shape)} for a frame of {blocks} blocks, {nc} components")
    coefs, quant = coefs.contiguous(), quant.contiguous()
    dec = _decoder(coefs.device)
    plan = plan_batch([frame], dec.sms)
    stream = torch.cuda.current_stream(dec.device)
    dev, at = dec.stage([[plan.table], [plan.prefix]], stream)
    out = torch.empty(max(plan.out_bytes, 16), dtype=torch.uint8, device=dec.device)
    base = dev.data_ptr()
    dec.launch(plan, (base + at[0], base + at[1]), coefs.data_ptr(), quant.data_ptr(),
               out.data_ptr(), stream)
    at, shape = plan.outputs[0]
    return out[at : at + shape[0] * shape[1] * 3].view(shape)


jpeg_pixels_cuda.launches = 0


def decode_jpeg(data: bytes, path: str, device: torch.device,
                source: str = BUFFER) -> torch.Tensor:
    """JPEG bytes -> the (H, W, 3) RGB uint8 image as a tensor on ``device``:
    on a CUDA device the compiled entropy decoder and J1 (a batch of one), on
    the CPU the plain decoder and the plain pixel stage. ``source`` is
    ``"file"`` (read as ``cv2.imread`` reads a file) or ``"buffer"`` (as
    ``cv2.imdecode`` reads bytes)."""
    device = torch.device(device)
    if device.type == "cuda":
        co = entropy_decode(data, path, source)
    else:
        co = decode_coefficients(data, path, source)
    return jpeg_pixels_batch([co], device)[0]
