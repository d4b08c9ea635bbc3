"""K2: streaming brute-force L2 top-k, a hand-written CUDA kernel for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/topk_kernel.py``
(``_topk_kernel``). The kernel is ``csrc/topk.cu``: the products on the
tensor cores in 3xTF32 (``wgmma`` fed by TMA, the refs split in
registers), persistent blocks that each carry a running best-k per query
over their own run of ref tiles, then a per-query merge of the blocks'
lists; its source note gives the bound and the design.
``topk_l2_stream_plain`` below is its plain PyTorch version: the CPU path
of the wrapper, and what ``chip_smoke.py`` holds the kernel against.
``topk_l2_3xtf32_plain`` emulates the kernel's split arithmetic for the
tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from soft_contrastive_learning_torch.ops.kernels import _build

# the blocks' running lists; topk_l2_cuda raises above it, and ops/topk.py
# routes larger k to the dense topk_l2
MAX_K = 128
TILE_ROWS = 128  # refs per tile of the partial kernel (scl_topk_tile_rows)
_MAX_REFS = 2**31 - TILE_ROWS  # ids and tile offsets are int32
_HI_MASK = -8192  # 0xffffe000 as int32: sign, exponent, the top 10 mantissa bits


def topk_l2_stream_plain(
    queries: torch.Tensor, refs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances, indices) of the k nearest refs per query, ascending L2,
    by the kernel's arithmetic: score = 2 q.r - |r|^2 in fp32, ties to the
    smallest index, distance sqrt(max(|q|^2 - score, 0)), and (inf, -1)
    padding when there are fewer than k refs."""
    q = queries.float()
    r = refs.float()
    k_eff = min(k, r.shape[0])
    scores = 2.0 * (q @ r.T) - (r * r).sum(dim=1)[None, :]
    # a stable descending sort keeps equal scores in ascending index order
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_eff], idx[:, :k_eff]
    qsq = (q * q).sum(dim=1, keepdim=True)
    dists = torch.sqrt(torch.clamp(qsq - top, min=0.0))
    if k_eff < k:
        pad = k - k_eff
        dists = torch.nn.functional.pad(dists, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return dists, idx


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``x``: hi is x with its low 13 mantissa bits zeroed
    (through an int32 view: at most 11 significant bits, a tf32 value), lo =
    x - hi, exact in fp32, so hi + lo == x."""
    x = x.float().contiguous()
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    return hi, x - hi


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to the nearest tf32 value (half away from zero) by
    bit operations, as the kernel rounds lo before it reaches the tensor
    cores."""
    x = x.float().contiguous()
    return ((x.view(torch.int32) + 0x1000) & _HI_MASK).view(torch.float32)


def topk_l2_3xtf32_plain(
    queries: torch.Tensor, refs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_l2_stream_plain`` with K2's product: q.r ~ q_hi.r_hi +
    q_hi.r_lo + q_lo.r_hi over the ``tf32_split`` parts, lo rounded by
    ``tf32_round``; the products of tf32 values are exact, and their sum is
    taken in fp64 and rounded once to fp32 (the kernel adds them in fp32 in
    its own order). The rest is the plain version's: score = 2 q.r - |r|^2,
    |r|^2 in fp32, ties to the smallest index. For the tests only."""
    q_hi, q_lo = tf32_split(queries)
    r_hi, r_lo = tf32_split(refs)
    q_lo, r_lo = tf32_round(q_lo), tf32_round(r_lo)
    dot = (q_hi.double() @ r_hi.double().T + q_hi.double() @ r_lo.double().T
           + q_lo.double() @ r_hi.double().T).float()
    r = refs.float()
    scores = 2.0 * dot - (r * r).sum(dim=1)[None, :]
    k_eff = min(k, r.shape[0])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_eff], idx[:, :k_eff]
    q = queries.float()
    # the square root correctly rounded, as the kernel's sqrtf (fp64, then
    # one rounding; torch's vectorized fp32 sqrt on the CPU can be an ulp off)
    dists = torch.sqrt(torch.clamp((q * q).sum(dim=1, keepdim=True) - top, min=0.0).double())
    dists = dists.float()
    if k_eff < k:
        dists = torch.nn.functional.pad(dists, (0, k - k_eff), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, k - k_eff), value=-1)
    return dists, idx


@functools.lru_cache(maxsize=None)  # the tile size is verified once, not per launch
def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    fn = lib.scl_topk_l2
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scl_topk_num_lists.argtypes = [ctypes.c_int] * 3
    lib.scl_topk_num_lists.restype = ctypes.c_int
    lib.scl_topk_stages.argtypes = [ctypes.c_int]
    lib.scl_topk_stages.restype = ctypes.c_int
    lib.scl_topk_smem_bytes.argtypes = [ctypes.c_int]
    lib.scl_topk_smem_bytes.restype = ctypes.c_size_t
    lib.scl_topk_tile_rows.argtypes = []
    lib.scl_topk_tile_rows.restype = ctypes.c_int
    if lib.scl_topk_tile_rows() != TILE_ROWS:
        raise RuntimeError(f"topk.cu was built with {lib.scl_topk_tile_rows()}-row tiles, the "
                           f"wrapper expects {TILE_ROWS}")
    return lib


def topk_l2_cuda(
    queries: torch.Tensor, refs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_l2_stream_plain`` through K2 for CUDA tensors; the plain
    version for CPU tensors. Takes fp32 (Q, D) queries and (R, D) refs with
    D % 4 == 0 and 0 < k <= 128; raises on anything else."""
    if queries.device.type == "cpu":
        return topk_l2_stream_plain(queries, refs, k)
    if queries.device.type != "cuda" or refs.device != queries.device:
        raise ValueError(f"topk_l2_cuda: queries on {queries.device}, refs on {refs.device}")
    if queries.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError("K2 takes float32 queries and refs")
    nq, d = queries.shape
    n_refs = refs.shape[0]
    if refs.ndim != 2 or refs.shape[1] != d:
        raise ValueError(f"refs {tuple(refs.shape)} do not match queries {tuple(queries.shape)}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"K2 takes 0 < k <= {MAX_K}, got {k}")
    if d % 4:
        raise ValueError(f"K2 needs D % 4 == 0 (TMA rows 16 bytes apart), got D={d}")
    if n_refs > _MAX_REFS:
        raise ValueError(f"K2 takes at most {_MAX_REFS} refs (int32 ids), got {n_refs}")
    dists = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=queries.device)
    if nq == 0:
        return dists, idx
    if n_refs == 0:
        return dists.fill_(float("inf")), idx.fill_(-1)
    q = queries.contiguous()
    r = refs.contiguous()
    if q.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("K2 needs 16-byte aligned queries and refs")
    lib = _lib()
    p = min(k, n_refs)
    with torch.cuda.device(q.device):
        n_lists = lib.scl_topk_num_lists(nq, n_refs, p)  # one list per block of a query tile
        if n_lists <= 0:
            _build.check(lib, -n_lists, "topk_l2_cuda (occupancy)")
        q_split = torch.empty((2, nq, d), dtype=torch.float32, device=q.device)
        part_s = torch.empty((nq, n_lists, p), dtype=torch.float32, device=q.device)
        part_i = torch.empty((nq, n_lists, p), dtype=torch.int32, device=q.device)
        err = lib.scl_topk_l2(
            q.data_ptr(), q_split.data_ptr(), r.data_ptr(), part_s.data_ptr(),
            part_i.data_ptr(), dists.data_ptr(), idx.data_ptr(), nq, n_refs, d, k, p, n_lists,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "topk_l2_cuda")
    _build.count_launch(topk_l2_cuda)
    return dists, idx


topk_l2_cuda.launches = 0
