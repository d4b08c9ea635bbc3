"""Brute-force top-k retrieval over a device-resident descriptor index, the
counterpart of ``soft_contrastive_learning_tpu/ops/topk.py``.

``topk_l2`` is the dense formulation (the JAX package computes it outside
Pallas, so it stays plain PyTorch here). ``topk_l2_streamed`` is the
memory-bounded path for large indexes: K2 on a CUDA device for k <= 128
(any width: zero columns pad it to K2's multiple of 4), its plain version
on the CPU, and the dense path for larger k, as the JAX dispatcher routes
k > 128 away from its kernel. ``topk_l2_sharded`` searches an index split
row-wise over the ranks of a mesh (``parallel/mesh.py``): each rank runs
``topk_l2_streamed`` (K2 on a card) over its own rows, and the ranks'
candidates are gathered and merged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from soft_contrastive_learning_torch.ops.distances import cross_sq_dists
from soft_contrastive_learning_torch.ops.kernels.topk import MAX_K, topk_l2_cuda
from soft_contrastive_learning_torch.parallel.mesh import Mesh, all_gather_rows

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


def topk_l2_sharded(
    queries: torch.Tensor, refs_shard: torch.Tensor, k: int, mesh: Optional[Mesh] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an index whose rows are split over the mesh's ranks in
    rank order, every rank holding as many (rank r: global rows r*S ..
    (r+1)*S - 1 of S); the queries are the same on every rank, and so is the
    result. Each rank takes its local top-min(k, S) by ``topk_l2_streamed``
    (K2 on a card), offsets the ids by its first row, and the (Q, n*k)
    candidates are gathered in rank order and merged by a stable sort of
    their distances, so that ties go to the smallest global id, as
    ``lax.top_k`` sends them in JAX's merge. JAX merges the squared
    distances; the merge here sorts the square roots K2 returns, which
    order two candidates apart only where their squares are equal or
    within a rounding of the root (compare by distance there). Without a
    mesh, or with one rank: ``topk_l2``, as JAX."""
    if mesh is None or mesh.size == 1:
        return topk_l2(queries, refs_shard, k)
    rows = refs_shard.shape[0]
    dists, ids = topk_l2_streamed(queries, refs_shard, min(k, rows))
    ids = ids + mesh.rank * rows
    # (Q, k) -> gathered (n, Q, k) -> (Q, n*k) in rank order
    all_d = all_gather_rows(dists[None], mesh).permute(1, 0, 2).reshape(len(queries), -1)
    all_i = all_gather_rows(ids[None], mesh).permute(1, 0, 2).reshape(len(queries), -1)
    top, pos = torch.sort(all_d, dim=1, stable=True)
    return top[:, :k], torch.gather(all_i, 1, pos[:, :k])
