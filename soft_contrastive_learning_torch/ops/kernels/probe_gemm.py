"""The matmul-rate probes' kernel: a hand-written tiled batched matrix
product for Hopper.

Replaces the Pallas kernels of the probe scripts under ``perf/``
(``mxu_probe.py::resident_dot`` and ``blocked_grid``,
``mxu_probe2.py``/``mxu_probe3.py``/``mxu_probe4.py::pallas_matmul``,
``matmul_probe.py::probe``), which are one function, ``C[z] = A[z] . B[z]``,
asked at different shapes, types and blockings. The kernels are in
``csrc/probe_gemm.cu``; its source note gives the bound and the design:
both types go through ``wgmma`` fed by TMA, bf16 operands with fp32 sums
(an fp32 or bf16 result), int8 operands with exact int32 sums, after a
hand-written transpose of B into an (N, K) scratch (``wgmma`` takes int8
only K-major). Tile shapes are a short compiled list per type
(``CONFIGS``), chosen by argument. M may be ragged (the kernels mask the
last tile); N and K must be multiples of the tile's BN and BK, and TMA
takes operands only at 16-byte-aligned addresses with rows a multiple of
16 bytes apart.

It is a measuring instrument, not a layer of the model: the scripts in
``soft_contrastive_learning_torch/perf/`` time it beside ``torch.matmul`` /
``torch._int_mm``, which nothing here calls for its result. The plain
version is ``probe_gemm_plain``: the CPU path of the wrapper and what
``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from soft_contrastive_learning_torch.ops.kernels import _build

# (BM, BN, BK) of csrc/probe_gemm.cu's tile shapes per operand type, checked
# against the library when it loads; both on wgmma + TMA, BK one swizzle row
# of 128 bytes, or of 64 in two int8 tiles (K = 192 takes only those)
CONFIGS: Dict[torch.dtype, Tuple[Tuple[int, int, int], ...]] = {
    torch.bfloat16: ((128, 256, 64), (128, 128, 64), (128, 64, 64)),
    torch.int8: ((128, 256, 128), (128, 256, 64), (128, 128, 128), (128, 64, 64)),
}
ROUTES = {torch.bfloat16: "wgmma", torch.int8: "wgmma"}
_PREFERENCE = {torch.bfloat16: (0, 1, 2), torch.int8: (0, 1, 2, 3)}  # largest tiles first
_MIN_BLOCKS = 132  # one block per SM of the H100
_OUT_DTYPES = {torch.bfloat16: (torch.float32, torch.bfloat16), torch.int8: (torch.int32,)}


@functools.lru_cache(maxsize=None)  # the tile list is verified once, not per launch
def _lib() -> ctypes.CDLL:
    lib = _build.load("probe_gemm")
    fn = lib.scl_probe_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scl_probe_transpose_s8.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    lib.scl_probe_transpose_s8.restype = ctypes.c_int
    lib.scl_probe_gemm_num_configs.argtypes = [ctypes.c_int]
    lib.scl_probe_gemm_num_configs.restype = ctypes.c_int
    lib.scl_probe_gemm_config.argtypes = [ctypes.c_int] * 3
    lib.scl_probe_gemm_config.restype = ctypes.c_int
    for dtype, configs in CONFIGS.items():
        int8 = int(dtype == torch.int8)
        built = tuple(tuple(lib.scl_probe_gemm_config(int8, i, w) for w in range(3))
                      for i in range(lib.scl_probe_gemm_num_configs(int8)))
        if built != configs:
            raise RuntimeError(f"probe_gemm.cu was built with {dtype} tiles {built}, the "
                               f"wrapper expects {configs}")
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    if a.dtype not in _OUT_DTYPES:
        raise TypeError(f"probe_gemm takes bfloat16 or int8 operands, got {a.dtype}")
    out_dtype = out_dtype or _OUT_DTYPES[a.dtype][0]
    if out_dtype not in _OUT_DTYPES[a.dtype]:
        raise TypeError(f"probe_gemm takes bfloat16 -> float32 | bfloat16 and int8 -> int32, "
                        f"got {a.dtype} -> {out_dtype}")
    if a.ndim not in (2, 3) or a.ndim != b.ndim or a.shape[-1] != b.shape[-2] \
            or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"expected a (Z, M, K) and b (Z, K, N) or both without Z, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return out_dtype


def probe_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.matmul`` of the operands with the kernel's arithmetic: bf16
    operands upcast to fp32 (a product of two bf16 values is exact there),
    summed in fp32, then the cast; int8 operands summed exactly (int32 on the
    CPU; fp64 on a CUDA device, where there is no integer matmul and every
    sum of K <= 2^38 products is exact), then int32."""
    out_dtype = _check(a, b, out_dtype)
    if a.dtype == torch.int8:
        if a.device.type == "cpu":
            return torch.matmul(a.int(), b.int())
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def choose_config(m: int, n: int, k: int, z: int = 1, dtype: torch.dtype = torch.bfloat16) -> int:
    """The largest of the type's tile shapes that divides N and K and still
    gives a block per SM; failing that, the dividing shape with the most
    blocks. Raises when none divides."""
    configs = CONFIGS[dtype]
    fits = [i for i in _PREFERENCE[dtype] if n % configs[i][1] == 0 and k % configs[i][2] == 0]
    if not fits:
        raise ValueError(f"probe_gemm: no tile shape of {dtype} {configs} (BM, BN, BK) "
                         f"divides N={n} and K={k}")
    for i in fits:
        bm, bn, _ = configs[i]
        if z * -(-m // bm) * (n // bn) >= _MIN_BLOCKS:
            return i
    return fits[-1]


def plan_launch(shape_a: Tuple[int, ...], shape_b: Tuple[int, ...], dtype: torch.dtype,
                config: Optional[int] = None, a_ptr: int = 0, b_ptr: int = 0) -> int:
    """The tile shape a launch on contiguous operands of these shapes and
    addresses would take (``config``, default ``choose_config``); raises on
    what the kernel does not take: an empty operand, a tile that does not
    divide N and K, a grid past its limits, and (TMA) an operand base that
    is not 16-byte aligned or rows not a multiple of 16 bytes apart."""
    z = shape_a[0] if len(shape_a) == 3 else 1
    m, k, n = shape_a[-2], shape_a[-1], shape_b[-1]
    if min(z, m, n, k) <= 0:
        raise ValueError(f"probe_gemm takes non-empty operands, got {tuple(shape_a)} and "
                         f"{tuple(shape_b)}")
    configs = CONFIGS[dtype]
    if config is None:
        config = choose_config(m, n, k, z, dtype)
    if not 0 <= config < len(configs):
        raise ValueError(f"config {config} outside 0..{len(configs) - 1} for {dtype}")
    bm, bn, bk = configs[config]
    if n % bn or k % bk:
        raise ValueError(f"tile shape {configs[config]} needs N % {bn} == 0 and K % {bk} == 0; "
                         f"got N={n}, K={k}")
    if a_ptr % 16 or b_ptr % 16:
        raise ValueError(f"probe_gemm: TMA needs 16-byte-aligned operands; a at {a_ptr:#x}, "
                         f"b at {b_ptr:#x}")
    if (dtype.itemsize * k) % 16 or (dtype.itemsize * n) % 16:
        raise ValueError(f"probe_gemm: TMA needs rows a multiple of 16 bytes apart; got "
                         f"K={k}, N={n} {dtype} values")
    blocks_x = -(-m // bm) * (n // bn)  # grid (tiles, 1, Z)
    if z > 65535 or blocks_x >= 2**31 or max(m, n, k) >= 2**31 \
            or max(z * m * k, z * k * n, z * m * n) >= 2**62:
        raise ValueError(f"probe_gemm: grid out of range for {tuple(shape_a)} @ {tuple(shape_b)}")
    return config


def probe_gemm(a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
               config: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` through the hand-written kernel for CUDA tensors, the
    plain version for CPU tensors. a (M, K) or (Z, M, K), b (K, N) or
    (Z, K, N), contiguous; ``config`` indexes ``CONFIGS[a.dtype]`` (default:
    ``choose_config``). Raises on anything the kernel does not take
    (``plan_launch``)."""
    out_dtype = _check(a, b, out_dtype)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_gemm_plain(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"probe_gemm: a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_gemm takes contiguous row-major operands")
    config = plan_launch(tuple(a.shape), tuple(b.shape), a.dtype, config, a.data_ptr(),
                         b.data_ptr())
    z = a.shape[0] if a.ndim == 3 else 1
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    lib = _lib()
    out = torch.empty((*a.shape[:-1], n), dtype=out_dtype, device=a.device)
    # int8: B's transpose, (Z, N, K), written by the call's first kernel
    bt = torch.empty((z, n, k), dtype=torch.int8, device=a.device) if a.dtype == torch.int8 \
        else None
    with torch.cuda.device(a.device):
        err = lib.scl_probe_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), 0 if bt is None else bt.data_ptr(),
            z, m, n, k,
            int(a.dtype == torch.int8), int(out_dtype == torch.bfloat16), config,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "probe_gemm")
    _build.count_launch(probe_gemm)
    return out


probe_gemm.launches = 0


def transpose_s8(b: torch.Tensor) -> torch.Tensor:
    """The int8 path's first kernel alone, to time it apart from the product:
    b (K, N) or (Z, K, N) int8, contiguous, K and N multiples of 64 -> its
    transpose (Z, N, K) (Z = 1 for a 2-D b). The plain ``transpose`` for a
    CPU tensor. ``probe_gemm`` runs the same kernel inside its call."""
    if b.dtype != torch.int8 or b.ndim not in (2, 3) or not b.is_contiguous():
        raise ValueError(f"transpose_s8 takes a contiguous (Z, K, N) int8 tensor, got "
                         f"{tuple(b.shape)} {b.dtype}")
    b3 = b if b.ndim == 3 else b[None]
    z, k, n = b3.shape
    if b.device.type == "cpu":
        return b3.transpose(1, 2).contiguous()
    if b.device.type != "cuda" or k % 64 or n % 64 or b.data_ptr() % 16:
        raise ValueError(f"transpose_s8: K={k} and N={n} must be multiples of 64 and b a "
                         f"16-byte-aligned CUDA tensor")
    bt = torch.empty((z, n, k), dtype=torch.int8, device=b.device)
    lib = _lib()
    with torch.cuda.device(b.device):
        err = lib.scl_probe_transpose_s8(b3.data_ptr(), bt.data_ptr(), z, k, n,
                                         torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "transpose_s8")
    return bt
