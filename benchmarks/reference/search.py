"""Exact nearest rows of an index, in float64, and the two numbers that
judge a served answer against them."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


@torch.no_grad()
def exact_topk(queries: torch.Tensor, index: torch.Tensor, k: int, block: int = 8192
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(distances, ids) of the k nearest rows of ``index`` (R, D) to each
    float64 query, ascending true L2, computed in float64 block by block
    (the index is read where it lies; no copy of it is made)."""
    q = queries.to(index.device, torch.float64)
    qn = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((len(q), 0), float("inf"), dtype=torch.float64, device=q.device)
    best_i = torch.zeros((len(q), 0), dtype=torch.int64, device=q.device)
    for s in range(0, index.shape[0], block):
        r = index[s : s + block].to(torch.float64)
        sq = (qn + (r * r).sum(dim=1)[None] - 2.0 * (q @ r.T)).clamp(min=0.0)
        d = torch.cat([best_d, sq], dim=1)
        ids = torch.cat([best_i, torch.arange(s, s + len(r), device=q.device)
                         .expand(len(q), -1)], dim=1)
        top = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
        best_d, best_i = top.values, torch.gather(ids, 1, top.indices)
    return best_d.sqrt().cpu().numpy(), best_i.cpu().numpy()


@torch.no_grad()
def row_distances(queries: torch.Tensor, index: torch.Tensor, ids: np.ndarray) -> np.ndarray:
    """Float64 L2 distance of query i to each row ``ids[i, j]``."""
    q = queries.to(index.device, torch.float64)
    rows = index[torch.as_tensor(ids.reshape(-1), device=index.device)].to(torch.float64)
    rows = rows.reshape(ids.shape[0], ids.shape[1], -1)
    return (rows - q[:, None, :]).norm(dim=-1).cpu().numpy()


def answer_gaps(served_d: np.ndarray, served_i: np.ndarray, ref_row_d: np.ndarray,
                ref_top_d: np.ndarray) -> Tuple[float, float]:
    """(dist_gap, rank_gap) of served answers (n, k), in squared distances
    (what a search computes; the root would magnify a near row's error):
    the largest gap between a served squared distance and the reference's
    to the row it names, and the largest gap between the reference's
    squared distance to the j-th served row and the true j-th nearest one
    (a wrong or missing neighbour)."""
    if not served_d.size:
        return 0.0, 0.0
    dist_gap = float(np.max(np.abs(served_d**2 - ref_row_d**2)))
    rank_gap = float(np.max(np.abs(ref_row_d**2 - ref_top_d**2)))
    return dist_gap, rank_gap
