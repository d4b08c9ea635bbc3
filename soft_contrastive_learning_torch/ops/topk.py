"""Brute-force top-k retrieval over a device-resident descriptor index, the
counterpart of ``soft_contrastive_learning_tpu/ops/topk.py``.

``topk_l2`` is the dense formulation (the JAX package computes it outside
Pallas, so it stays plain PyTorch here). ``topk_l2_streamed`` is the
memory-bounded path for large indexes: K2 on a CUDA device for k <= 128
(any width: zero columns pad it to K2's multiple of 4), its plain version
on the CPU, and the dense path for larger k, as the JAX dispatcher routes
k > 128 away from its kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from soft_contrastive_learning_torch.ops.distances import cross_sq_dists
from soft_contrastive_learning_torch.ops.kernels.topk import MAX_K, topk_l2_cuda

_QUERY_CHUNK = 256  # bounds the kernel's (Q, n_chunks, k) partial scratch


def topk_l2(
    queries: torch.Tensor, refs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances, indices) of the k <= R nearest refs per query, ascending
    true L2; ties go to the smallest index, as ``lax.top_k`` does
    (``torch.topk`` promises no tie order, a stable sort does)."""
    sq = cross_sq_dists(queries, refs)
    top, idx = torch.sort(sq, dim=1, stable=True)
    return torch.sqrt(torch.clamp(top[:, :k], min=0.0)), idx[:, :k]


def topk_l2_streamed(
    queries: torch.Tensor, refs: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k for large indexes without a (Q, R) distance matrix in device
    memory: K2 for k <= 128 (queries in chunks of 256), ``topk_l2`` above.
    K2 reads rows 16 bytes apart, so a width D that is not a multiple of 4
    is padded with zero columns first: they add exact zeros to every product
    and norm, and the result is the unpadded one's."""
    if k > MAX_K:
        return topk_l2(queries, refs, k)
    pad = (-queries.shape[1]) % 4
    if pad:
        queries = torch.nn.functional.pad(queries, (0, pad))
        refs = torch.nn.functional.pad(refs, (0, pad))
    outs = [topk_l2_cuda(queries[s : s + _QUERY_CHUNK], refs, k)
            for s in range(0, queries.shape[0], _QUERY_CHUNK)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
