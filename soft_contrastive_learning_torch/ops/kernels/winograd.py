"""K4: the fused Winograd F(2x2, 3x3) convolution, a hand-written CUDA
kernel for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/winograd_kernel.py``
(``_winograd_kernel``, ``winograd_conv_pallas``, and the ``winograd_conv``
custom_vjp). The kernel is ``csrc/winograd.cu``: a block owns a rectangle
of 32 tiles x 64 output channels and loops over the input channels in
chunks of 32; per chunk TMA brings the rectangle's input box (its halo and
ragged edge zero-filled by TMA, so there is no padded copy of x) and U's
chunk, shared across a cluster of ``CLUSTER`` blocks by multicast; the
threads transform the patches in bf16, ``wgmma`` multiplies the 16
positions, and the output transform, bias and ReLU finish in shared memory.
Its source note gives the bound and the design. The weight transform, which
the JAX wrapper runs before its ``pallas_call``, is a small kernel of the
same library (``weight_transform_cuda``), launched first; the cast of an
fp32 x to bf16 stays PyTorch.

The plain version is ``ops/winograd.py::winograd_conv_plain``: the CPU path
of the wrapper and what ``chip_smoke.py`` holds the kernel against.
``winograd_stage`` runs the same kernel cut short at a stage (``dma``,
``transform``, ``matmul``; ``full`` is ``winograd_conv_cuda``), the
counterpart of ``perf/winograd_ablate.py::make_kernel(stage)``; its plain
version is ``ops/winograd.py::winograd_stage_plain``.
``WinogradConvFn`` keeps the JAX split: K4 forward, and backward the
gradients of the direct convolution with both operands in the compute type
(cuDNN, as the JAX backward is XLA's convolution transpose).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from soft_contrastive_learning_torch.ops.kernels import _build
from soft_contrastive_learning_torch.ops.kernels._autograd import refuse_graph
from soft_contrastive_learning_torch.ops.winograd import (
    BLOCK_FEATURES,
    BLOCK_TILES,
    CHUNK,
    CLUSTER,
    block_grid,
    block_rows,
    stage_index,
    winograd_conv_plain,
    winograd_stage_plain,
)

_OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)  # the block's sizes are verified once, not per launch
def _lib() -> ctypes.CDLL:
    lib = _build.load("winograd")
    fn = lib.scl_winograd_conv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.scl_winograd_weight_transform
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.scl_winograd_stage
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("scl_winograd_chunk_channels", "scl_winograd_block_features",
                 "scl_winograd_block_tiles", "scl_winograd_smem_bytes",
                 "scl_winograd_cluster_blocks"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    built = (lib.scl_winograd_chunk_channels(), lib.scl_winograd_block_features(),
             lib.scl_winograd_block_tiles(), lib.scl_winograd_cluster_blocks())
    if built != (CHUNK, BLOCK_FEATURES, BLOCK_TILES, CLUSTER):
        raise RuntimeError(f"winograd.cu was built with (chunk, features, tiles, cluster) "
                           f"{built}, the wrapper expects "
                           f"{(CHUNK, BLOCK_FEATURES, BLOCK_TILES, CLUSTER)}")
    return lib


def weight_transform_cuda(weight: torch.Tensor) -> torch.Tensor:
    """``ops/winograd.py::weight_transform`` rounded to bf16, by the
    library's transform kernel: OIHW (F, C, 3, 3) on a CUDA device ->
    (16, C, F) bf16, the same bits as the PyTorch function gives."""
    if weight.device.type != "cuda" or weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"expected an OIHW 3x3 weight on a CUDA device, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    f, c = weight.shape[:2]
    if not 0 < c * f < 2**31:
        raise ValueError(f"K4's weight transform takes 0 < C * F < 2^31; got C={c}, F={f}")
    lib = _lib()
    w32 = weight.float().contiguous()
    u = torch.empty((16, c, f), dtype=torch.bfloat16, device=weight.device)
    with torch.cuda.device(weight.device):
        err = lib.scl_winograd_weight_transform(w32.data_ptr(), u.data_ptr(), c, f,
                                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "weight_transform_cuda")
    return u


def check_launch(what: str, x_shape, weight_shape, x_ptr: int = 0) -> Tuple[int, int]:
    """Raise on what the kernel does not take; returns (block rows, tile
    blocks rounded up to whole clusters) of the launch. Needs no library:
    the block's sizes are ``ops/winograd.py``'s, which ``_lib`` holds the
    library to when it loads."""
    if len(x_shape) != 4 or len(weight_shape) != 4 \
            or tuple(weight_shape[1:]) != (x_shape[-1], 3, 3):
        raise ValueError(f"shape mismatch: x {tuple(x_shape)} (NHWC), weight "
                         f"{tuple(weight_shape)} (OIHW 3x3)")
    b, h, w, c = x_shape
    f = weight_shape[0]
    if c % CHUNK or f % BLOCK_FEATURES:
        raise ValueError(f"{what} needs C % {CHUNK} == 0 and F % {BLOCK_FEATURES} == 0; got "
                         f"C={c}, F={f}")
    if x_ptr % 16:
        raise ValueError(f"{what}: TMA needs a 16-byte-aligned x; got x at {x_ptr:#x}")
    if min(b, h, w) <= 0 or max(b, h, w, c, f) >= 2**31:
        raise ValueError(f"{what} takes a non-empty input of fewer than 2^31 rows; got x "
                         f"{tuple(x_shape)}, F={f}")
    rows = block_rows(h, w)
    _, _, padded = block_grid(b, h, w, rows)
    if padded // CLUSTER > 65535:
        raise ValueError(f"{what}: {padded} tile blocks, more than 65,535 clusters of {CLUSTER}; "
                         f"got x {tuple(x_shape)}")
    return rows, padded


def _check_x(what: str, x: torch.Tensor, weight: torch.Tensor) -> Tuple[int, int]:
    if x.ndim == 4 and not x.is_contiguous():
        raise ValueError(f"{what} takes an NHWC-contiguous x (for an NCHW channels_last tensor "
                         "pass its permute(0, 2, 3, 1) view)")
    return check_launch(what, tuple(x.shape), tuple(weight.shape),
                        x.data_ptr() if x.dtype == torch.bfloat16 else 0)


def winograd_conv_cuda(
    x: torch.Tensor,  # (B, H, W, C) NHWC-contiguous, bf16 or fp32
    weight: torch.Tensor,  # (F, C, 3, 3) OIHW, the Conv2d parameter
    bias: torch.Tensor,  # (F,)
    relu: bool = False,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SAME 3x3 stride-1 conv + bias (+ ReLU) through K4 for CUDA tensors;
    the plain version for CPU tensors. Returns (B, H, W, F) in ``out_dtype``
    (default: x's dtype) with no autograd graph (``WinogradConvFn`` adds the
    backward); raises on anything the kernel does not take."""
    refuse_graph("winograd_conv_cuda", "WinogradConvFn", x, weight, bias)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return winograd_conv_plain(x, weight, bias, relu=relu, out_dtype=out_dtype)
    if x.device.type != "cuda" or {weight.device, bias.device} != {x.device}:
        raise ValueError(f"winograd_conv_cuda: x on {x.device}, weight on {weight.device}, "
                         f"bias on {bias.device}")
    if tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"shape mismatch: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if x.dtype not in _OUT_DTYPES or out_dtype not in _OUT_DTYPES:
        raise TypeError(f"K4 takes bfloat16 or float32 x and output, got {x.dtype} -> "
                        f"{out_dtype}")
    rows, _ = _check_x("K4", x, weight)
    lib = _lib()
    b, h, w, c = x.shape
    f = weight.shape[0]
    xb = x.to(torch.bfloat16)  # no copy when x is bf16 already
    u = weight_transform_cuda(weight)
    bias32 = bias.float().contiguous()
    out = torch.empty((b, h, w, f), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.scl_winograd_conv(
            xb.data_ptr(), u.data_ptr(), bias32.data_ptr(), out.data_ptr(), b, h, w, c, f,
            int(bool(relu)), int(out_dtype == torch.bfloat16), rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "winograd_conv_cuda")
    winograd_conv_cuda.launches += 1
    return out


winograd_conv_cuda.launches = 0


def winograd_stage(stage: int | str, x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, relu: bool = False,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K4 cut short at ``stage`` (0 ``dma``, 1 ``transform``, 2 ``matmul``,
    3 ``full``; ``winograd_stage_plain`` says what each returns) for CUDA
    tensors, the plain version for CPU tensors. ``full`` is
    ``winograd_conv_cuda`` itself and counts as its launch; the shorter
    stages count on ``winograd_stage.launches``."""
    stage = stage_index(stage)
    if stage == 3:
        if bias is None:
            raise ValueError("the full stage needs a bias")
        return winograd_conv_cuda(x, weight, bias, relu=relu, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return winograd_stage_plain(stage, x, weight)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"winograd_stage: x on {x.device}, weight on {weight.device}")
    if x.dtype not in _OUT_DTYPES:
        raise TypeError(f"winograd_stage takes bfloat16 or float32 x, got {x.dtype}")
    rows, tile_blocks = _check_x("winograd_stage", x, weight)
    lib = _lib()
    b, h, w, c = x.shape
    f = weight.shape[0]
    xb = x.to(torch.bfloat16)
    u = weight_transform_cuda(weight)
    if stage == 2:
        out = torch.empty((b * -(-h // 2) * -(-w // 2), f), dtype=torch.float32, device=x.device)
    else:  # one uint32 per block, carried in an int32 tensor
        out = torch.empty((tile_blocks, f // BLOCK_FEATURES), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.scl_winograd_stage(stage, xb.data_ptr(), u.data_ptr(), out.data_ptr(), b, h, w,
                                     c, f, rows, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "winograd_stage")
    winograd_stage.launches += 1
    return out if stage == 2 else out.to(torch.int64) & 0xFFFFFFFF


winograd_stage.launches = 0


def direct_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """The direct formulation whose gradients ``WinogradConvFn`` returns:
    NHWC x, both conv operands and the bias in x's dtype, output in x's
    dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype), padding=1)
    return (F.relu(y) if relu else y).permute(0, 2, 3, 1)


class WinogradConvFn(torch.autograd.Function):
    """``apply(x, weight, bias, relu)``: K4 forward (the plain version on
    CPU tensors), output in x's dtype. Backward: the gradients of
    ``direct_conv`` at the saved (x, weight, bias), with the weight and bias
    gradients cast back to the parameters' dtypes. Only what the ReLU mask
    needs is recomputed: the direct conv's forward, and only when ``relu``
    is set; the three gradients then come from one
    ``convolution_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu):
        ctx.save_for_backward(x, weight, bias)
        ctx.relu = bool(relu)
        return winograd_conv_cuda(x, weight, bias, relu=relu, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory (channels_last)
        wc = weight.to(x.dtype)
        g = grad.to(x.dtype).permute(0, 3, 1, 2)
        if ctx.relu:
            g = g * (F.conv2d(xc, wc, bias.to(x.dtype), padding=1) > 0)
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, xc, wc, [bias.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad[:3]))
        return (dx.permute(0, 2, 3, 1) if dx is not None else None,
                dw.to(weight.dtype) if dw is not None else None,
                db.to(bias.dtype) if db is not None else None, None)
