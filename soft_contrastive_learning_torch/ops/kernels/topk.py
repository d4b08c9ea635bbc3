"""K2: streaming brute-force L2 top-k, a hand-written CUDA kernel for Hopper.

Replaces ``soft_contrastive_learning_tpu/ops/pallas/topk_kernel.py``
(``_topk_kernel``). The kernel is ``csrc/topk.cu``: a split-R partial top-k
per (query tile, ref chunk) block, then a per-query merge; its source note
gives the bound and the design. ``topk_l2_stream_plain`` below is its plain
PyTorch version: the CPU path of the wrapper, and what ``chip_smoke.py``
holds the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from soft_contrastive_learning_torch.ops.kernels import _build

MAX_K = 128  # per-chunk best set, at most the 256-row chunk; larger k takes the plain path
_SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    fn = lib.scl_topk_l2
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scl_topk_chunk_rows.argtypes = []
    lib.scl_topk_chunk_rows.restype = ctypes.c_int
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
        raise ValueError(f"K2 needs D % 4 == 0 (float4 loads), got D={d}")
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
    n_chunks = -(-n_refs // lib.scl_topk_chunk_rows())
    if n_chunks * 4 > _SMEM_LIMIT:  # the merge keeps one int head per chunk
        raise ValueError(f"K2: {n_refs} refs exceed the merge's shared memory")
    part_s = torch.empty((nq, n_chunks, p), dtype=torch.float32, device=q.device)
    part_i = torch.empty((nq, n_chunks, p), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.scl_topk_l2(
            q.data_ptr(), r.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
            dists.data_ptr(), idx.data_ptr(), nq, n_refs, d, k, p, n_chunks,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "topk_l2_cuda")
    topk_l2_cuda.launches += 1
    return dists, idx


topk_l2_cuda.launches = 0
