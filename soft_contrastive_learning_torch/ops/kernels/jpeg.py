"""J1: the JPEG pixel stage, a hand-written CUDA kernel for Hopper, and the
compiled entropy decoder beside it.

J1 replaces no ``pl.pallas_call`` site: it replaces libjpeg-turbo's host
block smoothing, IDCT, upsampling and colour conversion, which the JAX
package runs through ``cv2.imread`` / ``cv2.imdecode``. The source is
``csrc/jpeg.cu`` (its note gives the bound and the design): one launch
(smoothing the blocks first where the frame is an incomplete progressive
image) dequantizes and inverse-transforms every 8x8 block into the
components' planes, a second upsamples, converts (gray, YCbCr, RGB, CMYK,
YCCK) and orients each output pixel; ``jpeg_pixels_cuda`` counts the pair as
one launch. The plain version is ``utils/jpeg.py::pixels_plain``: the
wrapper's path for CPU tensors and what ``chip_smoke.py`` holds J1 to, bit
for bit.

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

import numpy as np
import torch

from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.utils.jpeg import (
    BUFFER, FILE, Coefficients, Component, Frame, decode_coefficients, pixels_plain,
    upsample_mode)

_MAX_COMPS = 4
_SMOOTH_WORDS = 20
_INFO_LEN = 6 + 8 * _MAX_COMPS + 2 + _SMOOTH_WORDS * _MAX_COMPS
_GEOM_LEN = 10 + _SMOOTH_WORDS
_ERR_LEN = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("jpeg")
    _bind(lib)
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    """ctypes signatures of the library's entry points (the kernel's only
    where it was built by nvcc)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_jpeg_info.argtypes = [p, ctypes.c_int64, i, p, p, i]
    lib.scl_jpeg_info.restype = i
    lib.scl_jpeg_entropy.argtypes = [p, ctypes.c_int64, i, p, p, p, p, i]
    lib.scl_jpeg_entropy.restype = i
    if hasattr(lib, "scl_jpeg_pixels"):
        lib.scl_jpeg_pixels.argtypes = [p] * 5 + [i] * 8 + [ctypes.c_int64, p]
        lib.scl_jpeg_pixels.restype = i
    assert lib.scl_jpeg_info_len() == _INFO_LEN and lib.scl_jpeg_geometry_len() == _GEOM_LEN


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


def _geometry(frame: Frame) -> np.ndarray:
    """Per component (block0, plane0, bw, bh, dw, dh, hr, vr, fancy, v, then
    its 20 smoothing words) int64, what ``scl_jpeg_pixels`` takes; the planes
    one after another."""
    at = frame.block_offsets()
    rows, plane0 = [], 0
    for i, c in enumerate(frame.components):
        hr, vr, fancy = upsample_mode(c, frame.hmax, frame.vmax)
        words = (list(frame.smoothing[1 + _SMOOTH_WORDS * i : 1 + _SMOOTH_WORDS * (i + 1)])
                 if frame.smoothing else [0] * _SMOOTH_WORDS)
        rows.append([at[i], plane0, c.bw, c.bh, c.dw, c.dh, hr, vr, int(fancy), c.v, *words])
        plane0 += c.bw * c.bh * 64
    return np.asarray(rows, np.int64)


def jpeg_pixels_cuda(coefs: torch.Tensor, quant: torch.Tensor, frame: Frame) -> torch.Tensor:
    """The pixel stage through J1 for CUDA tensors, the plain version for CPU
    tensors: (blocks, 64) int16 coefficients in natural order and (ncomp, 64)
    int32 tables -> the oriented (H, W, 3) RGB uint8 image on their device.
    Raises on anything the kernel does not take."""
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
    lib = _lib()
    geom = _geometry(frame)
    coefs, quant = coefs.contiguous(), quant.contiguous()
    dev = coefs.device
    planes = torch.empty(blocks * 64, dtype=torch.uint8, device=dev)
    out = torch.empty((*frame.output_shape(), 3), dtype=torch.uint8, device=dev)
    smooth = frame.smoothing is not None
    with torch.cuda.device(dev):
        err = lib.scl_jpeg_pixels(
            coefs.data_ptr(), quant.data_ptr(), planes.data_ptr(), out.data_ptr(),
            geom.ctypes.data, nc, frame.colour, frame.orientation, frame.height, frame.width,
            int(smooth), frame.imcu_rows, frame.smoothing[0] if smooth else 0, blocks,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "jpeg_pixels_cuda")
    _build.count_launch(jpeg_pixels_cuda)
    return out


jpeg_pixels_cuda.launches = 0


def decode_jpeg(data: bytes, path: str, device: torch.device,
                source: str = BUFFER) -> torch.Tensor:
    """JPEG bytes -> the (H, W, 3) RGB uint8 image as a tensor on ``device``:
    on a CUDA device the compiled entropy decoder and J1, on the CPU the
    plain decoder and the plain pixel stage. ``source`` is ``"file"``
    (read as ``cv2.imread`` reads a file) or ``"buffer"`` (as
    ``cv2.imdecode`` reads bytes)."""
    if device.type == "cuda":
        co = entropy_decode(data, path, source)
    else:
        co = decode_coefficients(data, path, source)
    coefs = torch.from_numpy(co.coefs).to(device)
    return jpeg_pixels_cuda(coefs, torch.from_numpy(co.quant).to(device), co.frame)
