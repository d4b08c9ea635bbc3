"""Q1: the int8 convolution of the post-training-quantized VGG16 stack,
Q1_stem: its first conv with the input's requant, and Q1_pool, its 2x2
max-pool on int8, as hand-written CUDA kernels for Hopper.

They replace XLA work, not a Pallas kernel: the int8 ``conv_general_dilated``
(int8 x int8 -> int32) of ``soft_contrastive_learning_tpu/models/quant.py::
quantized_conv_stack`` with its fused elementwise epilogue, the input's
centring and requant before the first conv, and its ``reduce_window`` max on
int8. PyTorch has no int8 convolution on CUDA. The kernels are in
``csrc/int8_conv.cu``; its source note gives the bound and the design: a
persistent implicit GEMM (M = B H W pixels, N = F, K = 9 C) on integer
``wgmma`` fed by TMA, the input gathered tap by tap as 4-D boxes of the NHWC
map (zero-filled past the edge: SAME padding without a padded copy or an
im2col in memory), exact int32 sums, and the epilogue
``y = float(acc) * m[f] + bias[f]`` then ReLU and ``rint(y * inv_next)``
clipped to +-127 as int8, or y as fp32 for the stack's last conv, stored
through shared memory by TMA.

Weights come K-major, (F, 3, 3, C) int8 (``wgmma`` takes s8 only K-major).
The stem (C = 3) does not fit TMA's 16-byte rows: Q1_stem's producer
requantizes the raw image and gathers each pixel's 27 (r, s, c) values,
padded to 32, itself; ``stem_weight`` gives the matching (F, 1, 1, 32)
weights. Its plain version materializes the same columns (``stem_columns``)
for a 1x1 conv in ``int8_conv_plain``; Q1 itself takes only 3x3 convs.

Beside the kernels, ``int8_conv_plain`` (``F.conv2d`` in float64 on the int8
values, exact since every sum is below 2^53, cast to int32, then to fp32,
and the same epilogue in separate torch ops), ``int8_stem_plain`` and
``int8_pool_plain``. The wrappers take them for CPU tensors; for CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from soft_contrastive_learning_torch.ops.kernels import _build

STEM_K = 32  # the stem's 27 column values padded to one wgmma depth of int8
STEM_F = 64  # the stem's output channels (Q1_stem's one tile width)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    lib.scl_int8_conv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 11
                                  + [ctypes.c_void_p])
    lib.scl_int8_conv.restype = ctypes.c_int
    lib.scl_int8_stem.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float]
                                  + [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p])
    lib.scl_int8_stem.restype = ctypes.c_int
    lib.scl_int8_pool.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.scl_int8_pool.restype = ctypes.c_int
    lib.scl_int8_conv_config.argtypes = [ctypes.c_int] * 7
    lib.scl_int8_conv_config.restype = ctypes.c_int
    lib.scl_int8_stem_config.argtypes = [ctypes.c_int]
    lib.scl_int8_stem_config.restype = ctypes.c_int
    return lib


TILE_W = 16  # pixel columns of every tile


def tile_shape(c: int, f: int, out_f32: bool = False) -> tuple:
    """(TH, TW, BN, BK, CONS) of Q1's launch for C input and F output
    channels: a tile of TH x 16 pixels by BN output channels, K in steps of
    BK input channels (one swizzle row), CONS consumer warpgroups a block.
    The fp32 output (conv5_3) takes 8 x 16 tiles by 256 at BK 64 (its staged
    tile is 4 bytes a value, 128 KB), two consumers sharing one, one block an
    SM; int8 output at F a multiple of 256 (conv3_x .. conv5_2) likewise at
    BK 128 where C allows it. The other int8 layers have short K and large
    maps: F a multiple of 128 (conv2_x) takes 16 x 16 tiles by 128, two
    consumers sharing one; C = F = 64 (conv1_2) 8 x 16 tiles by 64 with its
    36 KB of weights kept in shared memory, one consumer each and two blocks
    an SM, so that one block's epilogue runs beside the other's products.
    Raises for a layer none of these take."""
    if c % 64 or (f % 128 and (f, c) != (64, 64)) or (out_f32 and f % 256):
        raise ValueError(f"Q1 takes C and F multiples of 64, F of 128 but at C = F = 64, F of "
                         f"256 for an fp32 output, got C={c}, F={f}, fp32 output {out_f32}")
    if out_f32:
        return 8, TILE_W, 256, 64, 2
    if f % 256 == 0 and c % 128 == 0:
        return 8, TILE_W, 256, 128, 2
    if f % 128 == 0:
        return 16, TILE_W, 128, 64, 2
    return 8, TILE_W, 64, 64, 1


def _check(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor) -> int:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"Q1 takes int8 x and w, got {x.dtype} and {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[1] != w.shape[2] or w.shape[1] not in (1, 3) \
            or w.shape[3] != x.shape[3]:
        raise ValueError(f"Q1 takes x (B, H, W, C) and w (F, T, T, C) with T 1 or 3, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    f = w.shape[0]
    if mult.shape != (f,) or bias.shape != (f,) or mult.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise ValueError(f"Q1 takes fp32 mult and bias of shape ({f},), got "
                         f"{tuple(mult.shape)} {mult.dtype} and {tuple(bias.shape)} {bias.dtype}")
    return w.shape[1]


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                    inv_next: float, relu: bool, out_f32: bool) -> torch.Tensor:
    """Q1's function in plain torch ops: the SAME conv of int8 x (B, H, W, C)
    by int8 w (F, T, T, C) summed exactly (float64, then int32), then
    ``y = acc.float() * mult + bias``; ``out_f32``: y (B, H, W, F) fp32;
    else ReLU where ``relu`` and ``clip(round(y * inv_next), -127, 127)`` as
    int8 (round half to even)."""
    t = _check(x, w, mult, bias)
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), w.permute(0, 3, 1, 2).double(),
                   padding=t // 2)
    return epilogue_plain(acc.permute(0, 2, 3, 1).to(torch.int32), mult, bias, inv_next, relu,
                          out_f32)


def epilogue_plain(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor, inv_next: float,
                   relu: bool, out_f32: bool) -> torch.Tensor:
    """Q1's epilogue on int32 sums (..., F): ``y = acc.float() * mult +
    bias``; ``out_f32``: y; else ReLU where ``relu`` and
    ``clip(round(y * inv_next), -127, 127)`` as int8 (round half to even)."""
    y = acc.float() * mult + bias
    if out_f32:
        return y.contiguous()
    if relu:
        y = torch.relu(y)
    return requant_plain(y, inv_next).contiguous()


def int8_conv(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
              inv_next: float, relu: bool, out_f32: bool) -> torch.Tensor:
    """``int8_conv_plain``'s function through Q1 for CUDA tensors (a 3x3 conv),
    the plain version for CPU tensors. ``inv_next`` must be an fp32 value (the
    kernel takes it as one). Raises on anything the kernel does not take."""
    t = _check(x, w, mult, bias)
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, mult, bias, inv_next, relu, out_f32)
    if t != 3:
        raise ValueError(f"Q1 takes a 3x3 conv, got w {tuple(w.shape)}")
    if x.device.type != "cuda" or any(v.device != x.device for v in (w, mult, bias)):
        raise ValueError(f"Q1: x on {x.device}, w on {w.device}, mult on {mult.device}, "
                         f"bias on {bias.device}")
    if not all(v.is_contiguous() for v in (x, w, mult, bias)):
        raise ValueError("Q1 takes contiguous tensors")
    b, h, wd, c = x.shape
    f = w.shape[0]
    th, tw, bn, bk, cons = tile_shape(c, f, out_f32)
    if x.data_ptr() % 16 or w.data_ptr() % 16 or mult.data_ptr() % 8 or bias.data_ptr() % 8:
        raise ValueError("Q1: TMA needs 16-byte-aligned x and w, the epilogue 8-byte-aligned "
                         "mult and bias")
    tiles = -(-h // th) * -(-wd // tw) * (f // bn)
    if b * tiles >= 2**31 or b * h * wd * max(c, f) >= 2**62:
        raise ValueError(f"Q1: grid out of range for x {tuple(x.shape)}")
    out = torch.empty((b, h, wd, f), dtype=torch.float32 if out_f32 else torch.int8,
                      device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.scl_int8_conv(x.data_ptr(), w.data_ptr(), out.data_ptr(), mult.data_ptr(),
                                bias.data_ptr(), float(inv_next), int(relu), int(out_f32),
                                b, h, wd, c, f, th, bn, bk, cons,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "Q1 int8_conv")
    _build.count_launch(int8_conv)
    return out


int8_conv.launches = 0


def int8_pool_plain(x: torch.Tensor) -> torch.Tensor:
    """The 2x2 floor max-pool of int8 x (B, H, W, C), in plain torch ops."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4)).contiguous()


def int8_pool(x: torch.Tensor) -> torch.Tensor:
    """``int8_pool_plain``'s function through Q1_pool for CUDA tensors, the
    plain version for CPU tensors. x (B, H, W, C) int8 contiguous, C a
    multiple of 16."""
    if x.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"Q1_pool takes an int8 (B, H, W, C) tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return int8_pool_plain(x)
    b, h, w, c = x.shape
    if x.device.type != "cuda" or not x.is_contiguous() or c % 16 or x.data_ptr() % 16 \
            or h < 2 or w < 2 or b == 0:
        raise ValueError(f"Q1_pool takes a contiguous 16-byte-aligned CUDA tensor with C a "
                         f"multiple of 16 and H, W >= 2, got {tuple(x.shape)} on {x.device}")
    out = torch.empty((b, h // 2, w // 2, c), dtype=torch.int8, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.scl_int8_pool(x.data_ptr(), out.data_ptr(), b, h, w, c,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "Q1_pool int8_pool")
    _build.count_launch(int8_pool)
    return out


int8_pool.launches = 0


def stem_columns(x: torch.Tensor) -> torch.Tensor:
    """int8 x (B, H, W, C) with 9 C <= STEM_K -> (B, H, W, STEM_K): each
    pixel's 3x3 neighbourhood (zero past the edge) in (r, s, c) order, then
    zeros. A 1x1 conv of it by ``stem_weight(w)`` is the 3x3 conv of x by w."""
    b, h, w, c = x.shape
    if 9 * c > STEM_K:
        raise ValueError(f"stem_columns packs at most {STEM_K // 9} channels, got {c}")
    # (B, H, W, C, r, s) windows of the padded map, a view; one copy writes
    # them in (r, s, c) order into each pixel's first 9 C bytes
    windows = F.pad(x, (0, 0, 1, 1, 1, 1)).unfold(1, 3, 1).unfold(2, 3, 1)
    cols = torch.zeros((b, h, w, STEM_K), dtype=x.dtype, device=x.device)
    cols[..., : 9 * c].view(b, h, w, 3, 3, c).copy_(windows.permute(0, 1, 2, 4, 5, 3))
    return cols


def stem_weight(w: torch.Tensor) -> torch.Tensor:
    """K-major (F, 3, 3, C) -> (F, 1, 1, STEM_K): the taps' (r, s, c) order of
    ``stem_columns``, then zeros."""
    f = w.shape[0]
    flat = w.reshape(f, -1)
    return F.pad(flat, (0, STEM_K - flat.shape[1])).reshape(f, 1, 1, STEM_K).contiguous()


def requant_plain(y: torch.Tensor, inv: float) -> torch.Tensor:
    """fp32 y -> ``clip(round(y * inv), -127, 127)`` as int8 (round half to
    even), ``inv`` an fp32 value."""
    inv_t = torch.full((), inv, dtype=torch.float32, device=y.device)  # a fill: no host copy
    return torch.clamp(torch.round(y * inv_t), -127, 127).to(torch.int8)


def _check_stem(images, average_rgb, w, mult, bias) -> None:
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"Q1_stem takes RGB images (B, H, W, 3), got {tuple(images.shape)}")
    if w.dtype != torch.int8 or w.shape != (STEM_F, 1, 1, STEM_K):
        raise ValueError(f"Q1_stem takes the packed int8 weights ({STEM_F}, 1, 1, {STEM_K}) of "
                         f"stem_weight, got {tuple(w.shape)} {w.dtype}")
    for name, v, n in (("average_rgb", average_rgb, 3), ("mult", mult, STEM_F),
                       ("bias", bias, STEM_F)):
        if v.shape != (n,) or v.dtype != torch.float32:
            raise ValueError(f"Q1_stem takes an fp32 {name} of shape ({n},), got "
                             f"{tuple(v.shape)} {v.dtype}")


def int8_stem_plain(images: torch.Tensor, average_rgb: torch.Tensor, inv_in: float,
                    w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor, inv_next: float,
                    relu: bool = True) -> torch.Tensor:
    """Q1_stem's function in plain torch ops: the images (B, H, W, 3) as fp32,
    centred by ``average_rgb`` and requantized by ``inv_in``, then the 3x3
    conv of those int8 values as ``stem_columns`` by the packed ``w``
    (``stem_weight``) through ``int8_conv_plain``'s epilogue: (B, H, W, 64)
    int8."""
    _check_stem(images, average_rgb, w, mult, bias)
    a8 = requant_plain(images.float() - average_rgb, inv_in)
    return int8_conv_plain(stem_columns(a8), w, mult, bias, inv_next, relu, False)


def int8_stem(images: torch.Tensor, average_rgb: torch.Tensor, inv_in: float, w: torch.Tensor,
              mult: torch.Tensor, bias: torch.Tensor, inv_next: float,
              relu: bool = True) -> torch.Tensor:
    """``int8_stem_plain``'s function through Q1_stem for CUDA tensors (images
    uint8 or fp32, contiguous: the kernel reads the raw pixels), the plain
    version for CPU tensors. ``inv_in`` and ``inv_next`` must be fp32 values."""
    _check_stem(images, average_rgb, w, mult, bias)
    if images.device.type == "cpu":
        return int8_stem_plain(images, average_rgb, inv_in, w, mult, bias, inv_next, relu)
    if images.device.type != "cuda" or any(v.device != images.device
                                           for v in (average_rgb, w, mult, bias)):
        raise ValueError(f"Q1_stem: images on {images.device}, the rest on "
                         f"{[str(v.device) for v in (average_rgb, w, mult, bias)]}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"Q1_stem takes uint8 or fp32 images, got {images.dtype}")
    if not all(v.is_contiguous() for v in (images, average_rgb, w, mult, bias)):
        raise ValueError("Q1_stem takes contiguous tensors")
    if w.data_ptr() % 16 or mult.data_ptr() % 8 or bias.data_ptr() % 8:
        raise ValueError("Q1_stem: TMA needs 16-byte-aligned w, the epilogue 8-byte-aligned "
                         "mult and bias")
    b, h, wd, _ = images.shape  # a grid past 2^31 tiles is refused by the launch
    out = torch.empty((b, h, wd, STEM_F), dtype=torch.int8, device=images.device)
    lib = _lib()
    with torch.cuda.device(images.device):
        err = lib.scl_int8_stem(images.data_ptr(), int(images.dtype == torch.float32),
                                average_rgb.data_ptr(), float(inv_in), w.data_ptr(),
                                out.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                                float(inv_next), int(relu), b, h, wd,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "Q1_stem int8_stem")
    _build.count_launch(int8_stem)
    return out


int8_stem.launches = 0
