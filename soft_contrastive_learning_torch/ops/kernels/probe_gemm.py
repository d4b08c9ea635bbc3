"""The matmul-rate probes' kernel: a hand-written tiled batched matrix
product for Hopper.

Replaces the Pallas kernels of the probe scripts under ``perf/``
(``mxu_probe.py::resident_dot`` and ``blocked_grid``,
``mxu_probe2.py``/``mxu_probe3.py``/``mxu_probe4.py::pallas_matmul``,
``matmul_probe.py::probe``), which are one function, ``C[z] = A[z] . B[z]``,
asked at different shapes, types and blockings. The kernel is
``csrc/probe_gemm.cu``; its source note gives the bound and the design. Tile
shapes are a short compiled list (``CONFIGS``), chosen by argument. Types:
bf16 operands with fp32 sums and an fp32 or bf16 result; int8 operands with
an exact int32 result. M may be ragged (the kernel masks the last tile);
N and K must be multiples of the tile's BN and BK.

It is a measuring instrument, not a layer of the model: the scripts in
``soft_contrastive_learning_torch/perf/`` time it beside ``torch.matmul`` /
``torch._int_mm``, which nothing here calls for its result. The plain
version is ``probe_gemm_plain``: the CPU path of the wrapper and what
``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from soft_contrastive_learning_torch.ops.kernels import _build

# (BM, BN, BK) of csrc/probe_gemm.cu's instantiations, checked against the
# library when it loads
CONFIGS: Tuple[Tuple[int, int, int], ...] = (
    (64, 64, 32), (128, 128, 32), (128, 256, 32), (256, 128, 64))
_PREFERENCE = (2, 3, 1, 0)  # largest tiles first
_MIN_BLOCKS = 132  # one block per SM of the H100
_OUT_DTYPES = {torch.bfloat16: (torch.float32, torch.bfloat16), torch.int8: (torch.int32,)}


@functools.lru_cache(maxsize=None)  # the tile list is verified once, not per launch
def _lib() -> ctypes.CDLL:
    lib = _build.load("probe_gemm")
    fn = lib.scl_probe_gemm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scl_probe_gemm_num_configs.argtypes = []
    lib.scl_probe_gemm_num_configs.restype = ctypes.c_int
    lib.scl_probe_gemm_config.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.scl_probe_gemm_config.restype = ctypes.c_int
    built = tuple(tuple(lib.scl_probe_gemm_config(i, w) for w in range(3))
                  for i in range(lib.scl_probe_gemm_num_configs()))
    if built != CONFIGS:
        raise RuntimeError(f"probe_gemm.cu was built with tiles {built}, the wrapper "
                           f"expects {CONFIGS}")
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


def choose_config(m: int, n: int, k: int, z: int = 1) -> int:
    """The largest tile shape that divides N and K and still gives a block
    per SM; failing that, the dividing shape with the most blocks. Raises
    when none divides."""
    fits = [i for i in _PREFERENCE if n % CONFIGS[i][1] == 0 and k % CONFIGS[i][2] == 0]
    if not fits:
        raise ValueError(f"probe_gemm: no tile shape of {CONFIGS} (BM, BN, BK) divides "
                         f"N={n} and K={k}")
    for i in fits:
        bm, bn, _ = CONFIGS[i]
        if z * -(-m // bm) * (n // bn) >= _MIN_BLOCKS:
            return i
    return fits[-1]


def probe_gemm(a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
               config: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` through the hand-written kernel for CUDA tensors, the
    plain version for CPU tensors. a (M, K) or (Z, M, K), b (K, N) or
    (Z, K, N), contiguous; ``config`` indexes ``CONFIGS`` (default:
    ``choose_config``). Raises on anything the kernel does not take."""
    out_dtype = _check(a, b, out_dtype)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return probe_gemm_plain(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"probe_gemm: a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_gemm takes contiguous row-major operands")
    z = a.shape[0] if a.ndim == 3 else 1
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if min(z, m, n, k) <= 0:
        raise ValueError(f"probe_gemm takes non-empty operands, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if config is None:
        config = choose_config(m, n, k, z)
    if not 0 <= config < len(CONFIGS):
        raise ValueError(f"config {config} outside 0..{len(CONFIGS) - 1}")
    bm, bn, bk = CONFIGS[config]
    if n % bn or k % bk:
        raise ValueError(f"tile shape {CONFIGS[config]} needs N % {bn} == 0 and K % {bk} == 0; "
                         f"got N={n}, K={k}")
    if z > 65535 or -(-m // bm) > 65535 or max(z * m * k, z * k * n, z * m * n) >= 2**62:
        raise ValueError(f"probe_gemm: grid out of range for {tuple(a.shape)} @ {tuple(b.shape)}")
    lib = _lib()
    out = torch.empty((*a.shape[:-1], n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.scl_probe_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), z, m, n, k,
            int(a.dtype == torch.int8), int(out_dtype == torch.bfloat16), config,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "probe_gemm")
    probe_gemm.launches += 1
    return out


probe_gemm.launches = 0
