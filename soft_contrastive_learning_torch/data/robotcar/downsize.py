"""Stage 001: untar raw Bayer frames, demosaic (and undistort), downsize,
record each frame's exposure. Own copy of
``soft_contrastive_learning_tpu/data/robotcar/downsize.py``.

JAX runs OpenCV on the host, a frame at a time: ``cv2.imdecode``
(IMREAD_GRAYSCALE), ``cvtColor(COLOR_BayerGR2RGB)`` (RobotCar's stereo
frames are GBRG), ``remap(INTER_LINEAR)`` through the SDK's undistortion
LUT where a camera-models dir has one, ``cv2.resize`` to ``max_side``. The
port decodes the PNGs with its own codec on host threads, runs batches of
frames through ``demosaic_gbrg`` -> ``UndistortLUT`` -> ``resize_linear``
on ``device`` (the card unless the caller asks for the CPU), and encodes
the small PNGs on threads. Each of the three image ops returns OpenCV's
pixels (``tests/test_torch_robotcar_prep.py`` holds them equal to cv2) and
the same bits on the card and on the CPU: integers throughout, but for the
remap's float32 arithmetic, which is emulated exactly (below).

A frame's exposure is the float64 sum of its downsized pixels, as JAX's
``np.sum(small, dtype=np.float64)``; stage 004 drops over- and
under-exposed frames by it.

Only a frame that cannot be decoded (``ValueError`` from the codec) drops
its row. JAX's loop catches every exception there, so on a host without
OpenCV it drops every frame without a word; here a missing library or a
CUDA error stops the run.
"""

from __future__ import annotations

import os
import tarfile
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from soft_contrastive_learning_torch.core.config import resolve_device
from soft_contrastive_learning_torch.data.robotcar.stages import PrepContext
from soft_contrastive_learning_torch.utils.cv import resize_linear
from soft_contrastive_learning_torch.utils.io import (
    decode_gray,
    load_csv,
    save_csv,
    save_img,
    save_txt,
)

LUT_NAME = "stereo_narrow_left_distortion_lut.bin"
BATCH = 16  # frames through the device ops at once (the remap's temporaries: a few GB)
WORKERS = 8  # host threads decoding and encoding PNGs


def demosaic_gbrg(raw: torch.Tensor) -> torch.Tensor:
    """(B, H, W) or (H, W) uint8 GBRG Bayer -> (..., H, W, 3) uint8 RGB,
    ``cv2.cvtColor(raw, COLOR_BayerGR2RGB)`` pixel for pixel (OpenCV names
    a pattern by its 2x2 block from the second row and column, so its
    "GR" is RobotCar's G B / R G layout from the top-left).

    Bilinear, OpenCV's integer rounding: at a green site the two other
    colours are means of two neighbours, ``(a + b + 1) >> 1`` (left and
    right, or above and below, whichever carry that colour); at a red or
    blue site green is ``(4 neighbours + 2) >> 2`` and the third colour the
    same mean of the 4 diagonals. The outer rows and columns copy their
    inner neighbours (the columns first). Frames need 3 rows and columns."""
    squeeze = raw.ndim == 2
    x = raw[None] if squeeze else raw
    if x.dtype != torch.uint8 or x.ndim != 3:
        raise ValueError(f"demosaic_gbrg takes (B, H, W) or (H, W) uint8; got {x.dtype} "
                         f"{tuple(raw.shape)}")
    b, h, w = x.shape
    if h < 3 or w < 3:
        raise ValueError(f"a Bayer frame needs at least 3 rows and columns; got {h}x{w}")
    p = F.pad(x.to(torch.int16), (1, 1, 1, 1))

    def at(dy: int, dx: int) -> torch.Tensor:
        return p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    c = at(0, 0)
    across = (at(0, -1) + at(0, 1) + 1) >> 1
    down = (at(-1, 0) + at(1, 0) + 1) >> 1
    cross = (at(-1, 0) + at(1, 0) + at(0, -1) + at(0, 1) + 2) >> 2
    diag = (at(-1, -1) + at(-1, 1) + at(1, -1) + at(1, 1) + 2) >> 2
    even_row = (torch.arange(h, device=x.device) % 2 == 0)[:, None]
    even_col = (torch.arange(w, device=x.device) % 2 == 0)[None, :]
    green = even_row == even_col  # G B G B / R G R G
    blue = even_row & ~even_col
    red = ~even_row & even_col
    r = torch.where(red, c, torch.where(blue, diag, torch.where(even_row, down, across)))
    g = torch.where(green, c, cross)
    bl = torch.where(blue, c, torch.where(red, diag, torch.where(even_row, across, down)))
    out = torch.stack([r, g, bl], dim=-1)
    out[:, :, 0], out[:, :, -1] = out[:, :, 1], out[:, :, -2]
    out[:, 0], out[:, -1] = out[:, 1], out[:, -2]
    out = out.to(torch.uint8)
    return out[0] if squeeze else out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64, and so is the sum
    for the remap's operands (pixel values and fractions of coordinates
    above 2^-20 or so), so one rounding to float32 is the FMA's."""
    return (a.double() * b.double() + c.double()).float()


class UndistortLUT:
    """``cv2.remap(img, u, v, INTER_LINEAR)`` with a robotcar-sdk LUT (one
    row of u, then one of v, source coordinates per destination pixel, as
    float64) reshaped to ``shape`` and cast to float32, as JAX loads it.
    The tables, and the gather indices and fractions derived from them,
    live on ``device``.

    OpenCV 5's remap of 8-bit images interpolates in float32 (not the
    1/32-pixel fixed point of OpenCV 3-4): ``x0 = floor(u)``, ``a = u -
    x0``; ``v0 = fma(a, p01 - p00, p00)``, ``v1 = fma(a, p11 - p10, p10)``,
    ``out = round_half_even(fma(b, v1 - v0, v0))``, saturated to uint8; a
    neighbour outside the frame reads 0 (BORDER_CONSTANT)."""

    def __init__(self, lut_path: str, shape: Tuple[int, int], device="cuda"):
        lut = np.fromfile(lut_path, np.double).reshape(2, -1)
        self.shape = tuple(shape)
        self.u = torch.from_numpy(lut[0].reshape(shape).astype(np.float32)).to(device)
        self.v = torch.from_numpy(lut[1].reshape(shape).astype(np.float32)).to(device)
        x0, y0 = torch.floor(self.u), torch.floor(self.v)
        self.a, self.b = self.u - x0, self.v - y0
        self._x0, self._y0 = x0.long(), y0.long()

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) or (H, W, C) uint8 on the LUT's device -> the same
        at the LUT's shape."""
        squeeze = img.ndim == 3
        x = img[None] if squeeze else img
        h, w = x.shape[1], x.shape[2]
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(0, 2, 3, 1).float()

        def tap(dy: int, dx: int) -> torch.Tensor:  # zero outside the frame
            yy = (self._y0 + dy).clamp(-1, h) + 1
            xx = (self._x0 + dx).clamp(-1, w) + 1
            return xp[:, yy, xx]

        a, b = self.a[None, :, :, None], self.b[None, :, :, None]
        p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
        v0 = _fma(a, p01 - p00, p00)
        v1 = _fma(a, p11 - p10, p10)
        out = torch.round(_fma(b, v1 - v0, v0)).clamp_(0, 255).to(torch.uint8)
        return out[0] if squeeze else out


def decode_raw_image(data: bytes, undistort: Optional[UndistortLUT] = None,
                     device="cuda") -> np.ndarray:
    """One raw frame's PNG bytes -> demosaiced (and undistorted) RGB uint8,
    computed on ``device``. Raises ``ValueError`` for bytes that do not
    decode."""
    raw = torch.from_numpy(decode_gray(data)).to(device)
    rgb = demosaic_gbrg(raw)
    if undistort is not None:
        rgb = undistort(rgb)
    return rgb.cpu().numpy()


def find_undistort_lut(models_dir: str, h: int, w: int, device="cuda"
                       ) -> Optional[UndistortLUT]:
    """The SDK's LUT for (h, w) frames under ``models_dir``, or None where
    there is none or it does not hold 2 x h x w values (JAX's outcome)."""
    if not models_dir:
        return None
    lut_path = os.path.join(models_dir, LUT_NAME)
    if not os.path.exists(lut_path):
        return None
    try:
        return UndistortLUT(lut_path, (h, w), device)
    except ValueError:  # the reshape: a LUT for another frame size
        return None


def downsize_batch(raw: torch.Tensor, max_side: int,
                   undistort: Optional[UndistortLUT] = None) -> torch.Tensor:
    """(B, H, W) uint8 Bayer frames on a device -> (B, h, w, 3) uint8,
    ``max(h, w) == max_side``: demosaic, undistort, resize, on the frames'
    device."""
    rgb = demosaic_gbrg(raw)
    if undistort is not None:
        rgb = undistort(rgb)
    scale = max_side / float(max(rgb.shape[1], rgb.shape[2]))
    return resize_linear(rgb, scale, scale)


def _tar_frames(tar_path: str):
    """(timestamp, file name, PNG bytes) of each ``.png`` member, in the
    archive's order."""
    with tarfile.open(tar_path) as archive:
        for entry in archive.getmembers():
            name = os.path.basename(entry.name)
            if not name.endswith(".png"):
                continue
            with archive.extractfile(entry) as fh:
                yield name.split(".")[0], name, fh.read()


def downsize_images(ctx: PrepContext, date: str, device="cuda") -> None:
    """One date's tar archives -> downsized PNGs under ``ctx.img_root`` and
    the ``img_info_<max_side>/<date>.csv`` rows (t, folder, exposure) of the
    frames that decoded, in ``stereo.timestamps`` order. A date whose CSV
    exists is skipped."""
    out_file = os.path.join(ctx.dir(f"img_info_{ctx.max_side}"), f"{date}.csv")
    if os.path.exists(out_file):
        return
    device = resolve_device(device)
    imgs = load_csv(os.path.join(ctx.raw_img_root, date, "stereo.timestamps"),
                    has_header=False, delimiter=" ", keys=["t", "folder"])
    timestamps: List[str] = list(imgs["t"])
    folders: List[str] = list(imgs["folder"])
    exposures: Dict[str, float] = {}
    undistort: Optional[UndistortLUT] = None
    looked_up = False

    def decode(item):
        ts, name, data = item
        try:
            return ts, name, decode_gray(data, name)
        except ValueError:
            return ts, name, None  # an unreadable frame: its row is dropped

    def downsize(frames, out_dir):
        nonlocal undistort, looked_up
        frames = [f for f in frames if f[2] is not None]
        if frames and not looked_up and ctx.camera_models:
            h, w = frames[0][2].shape
            undistort = find_undistort_lut(ctx.camera_models, h, w, device)
            looked_up = True
        for shape in dict.fromkeys(f[2].shape for f in frames):  # one size a batch
            part = [f for f in frames if f[2].shape == shape]
            raw = torch.from_numpy(np.stack([f[2] for f in part])).to(device)
            small = downsize_batch(raw, ctx.max_side, undistort).cpu().numpy()
            for (ts, name, _), img in zip(part, small):
                exposures[ts] = float(np.sum(img, dtype=np.float64))
                writes.append(pool.submit(save_img, img, os.path.join(out_dir, name)))
        while len(writes) > 4 * BATCH:  # bound the images waiting to be written
            writes.popleft().result()

    writes: deque = deque()
    with ThreadPoolExecutor(WORKERS) as pool:
        for folder in range(1, max(int(f) for f in folders) + 1):
            tar_path = os.path.join(ctx.tar_root, f"{date}_stereo_centre_{folder:02d}.tar")
            if not os.path.exists(tar_path):
                save_txt(tar_path + "\n", os.path.join(ctx.dir(""), "missing.txt"), mode="a")
                continue
            out_dir = os.path.join(ctx.img_root, f"{date}_stereo_centre_{folder:02d}")
            os.makedirs(out_dir, exist_ok=True)
            frames = _tar_frames(tar_path)
            pending = None  # the next batch decodes while this one is on the device
            while True:
                chunk = [pool.submit(decode, f) for f in islice(frames, BATCH)]
                if pending:
                    downsize([f.result() for f in pending], out_dir)
                if not chunk:
                    break
                pending = chunk
        while writes:
            writes.popleft().result()

    rows = [(t, f) for t, f in zip(timestamps, folders) if t in exposures]
    save_csv({"t": [t for t, _ in rows], "folder": [f for _, f in rows],
              "exposure": [exposures[t] for t, _ in rows]}, out_file)
