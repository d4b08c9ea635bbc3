"""J1: the JPEG pixel stage, a hand-written CUDA kernel for Hopper, and the
compiled entropy decoder beside it.

J1 replaces no ``pl.pallas_call`` site: it replaces libjpeg-turbo's host
IDCT, upsampling and colour conversion, which the JAX package runs through
``cv2.imread`` / ``cv2.imdecode``. The source is ``csrc/jpeg.cu`` (its note
gives the bound and the design): one launch dequantizes and inverse-
transforms every 8x8 block into the components' planes, a second upsamples,
converts and orients each output pixel; ``jpeg_pixels_cuda`` counts the pair
as one launch. The plain version is ``utils/jpeg.py::pixels_plain``: the
wrapper's path for CPU tensors and what ``chip_smoke.py`` holds J1 to, bit
for bit.

``entropy_decode`` is the compiled counterpart of
``utils/jpeg.py::decode_coefficients``: host C++ in the same library, called
through ctypes (which releases the GIL, so decode threads run it in
parallel). It gives the same coefficient buffer and refuses the same files
with the same kind of reason. It needs the library, so ``nvcc``: the port
takes it where the image is decoded for a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.utils.jpeg import (
    Coefficients, Component, Frame, pixels_plain, upsample_mode)

_INFO_LEN = 6 + 8 * 3
_ERR_LEN = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("jpeg")
    p = ctypes.c_void_p
    lib.scl_jpeg_info.argtypes = [p, ctypes.c_int64, p, p, ctypes.c_int]
    lib.scl_jpeg_info.restype = ctypes.c_int
    lib.scl_jpeg_entropy.argtypes = [p, ctypes.c_int64, p, p, p, p, ctypes.c_int]
    lib.scl_jpeg_entropy.restype = ctypes.c_int
    lib.scl_jpeg_pixels.argtypes = ([p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64, p])
    lib.scl_jpeg_pixels.restype = ctypes.c_int
    return lib


def _frame(info: np.ndarray) -> Frame:
    """``Frame`` from the decoder's info words (``csrc/jpeg.cu::write_info``)."""
    comps = [Component(cid=int(k[0]), h=int(k[1]), v=int(k[2]), tq=int(k[3]), dw=int(k[4]),
                       dh=int(k[5]), bw=int(k[6]), bh=int(k[7]))
             for k in info[6 : 6 + 8 * int(info[2])].reshape(-1, 8)]
    return Frame(int(info[0]), int(info[1]), int(info[3]), int(info[4]), comps)


def entropy_decode(data: bytes, path: str = "image") -> Coefficients:
    """JPEG bytes -> ``Coefficients`` by the compiled decoder; raises
    ``ValueError`` naming ``path`` and the reason for a refused file."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.scl_jpeg_info(buf.ctypes.data, len(buf), info.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    frame = _frame(info)
    coefs = np.zeros((frame.block_offsets()[-1], 64), np.int16)
    quant = np.zeros((len(frame.components), 64), np.int32)
    if lib.scl_jpeg_entropy(buf.ctypes.data, len(buf), coefs.ctypes.data, quant.ctypes.data,
                            info.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return Coefficients(frame, coefs, quant)


def _geometry(frame: Frame) -> np.ndarray:
    """Per component (block0, plane0, bw, bh, dw, dh, hr, vr, fancy) int64,
    what ``scl_jpeg_pixels`` takes; the planes one after another."""
    at = frame.block_offsets()
    rows, plane0 = [], 0
    for i, c in enumerate(frame.components):
        hr, vr, fancy = upsample_mode(c, frame.hmax, frame.vmax)
        rows.append([at[i], plane0, c.bw, c.bh, c.dw, c.dh, hr, vr, int(fancy)])
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
    if coefs.shape != (blocks, 64) or quant.shape != (nc, 64) or nc not in (1, 3):
        raise ValueError(f"J1: coefficients {tuple(coefs.shape)} and tables "
                         f"{tuple(quant.shape)} for a frame of {blocks} blocks, {nc} components")
    lib = _lib()
    geom = _geometry(frame)
    coefs, quant = coefs.contiguous(), quant.contiguous()
    dev = coefs.device
    planes = torch.empty(blocks * 64, dtype=torch.uint8, device=dev)
    out = torch.empty((*frame.output_shape(), 3), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.scl_jpeg_pixels(
            coefs.data_ptr(), quant.data_ptr(), planes.data_ptr(), out.data_ptr(),
            geom.ctypes.data, nc, frame.colour, frame.orientation, frame.height, frame.width,
            blocks, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "jpeg_pixels_cuda")
    _build.count_launch(jpeg_pixels_cuda)
    return out


jpeg_pixels_cuda.launches = 0


def decode_jpeg(data: bytes, path: str, device: torch.device) -> torch.Tensor:
    """JPEG bytes -> the (H, W, 3) RGB uint8 image as a tensor on ``device``:
    on a CUDA device the compiled entropy decoder and J1, on the CPU the
    plain decoder and the plain pixel stage."""
    if device.type == "cuda":
        co = entropy_decode(data, path)
    else:
        from soft_contrastive_learning_torch.utils.jpeg import decode_coefficients

        co = decode_coefficients(data, path)
    coefs = torch.from_numpy(co.coefs).to(device)
    return jpeg_pixels_cuda(coefs, torch.from_numpy(co.quant).to(device), co.frame)
