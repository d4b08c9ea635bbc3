"""Distance computations, own copy of
``soft_contrastive_learning_tpu/ops/distances.py``: what retrieval and the
losses need. On CUDA the products assume
``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default (JAX
computes them at ``precision="highest"``)."""

from __future__ import annotations

import torch


def pairwise_sq_dists(features: torch.Tensor) -> torch.Tensor:
    """Batched pairwise squared L2 distances, (T, M, D) -> (T, M, M) with
    [t, i, j] = ||x_ti - x_tj||^2, by the r - 2xy + r^T expansion."""
    r = (features * features).sum(dim=-1)[:, :, None]  # (T, M, 1)
    prod = features @ features.transpose(1, 2)
    return r - 2.0 * prod + r.transpose(1, 2)


def sq_dists_to_anchor(anchor: torch.Tensor, others: torch.Tensor) -> torch.Tensor:
    """Squared distances from a (T, 1, D) anchor to (T, K, D) points -> (T, K)."""
    diff = others - anchor
    return (diff * diff).sum(dim=-1)


def cross_sq_dists(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (R, D) -> (Q, R) squared L2 distances via one fp32 product,
    clamped at 0.

    The q^2 - 2qr + r^2 expansion cancels catastrophically in fp32 for
    large-magnitude inputs; use it for unit-scale embeddings."""
    q = queries.float()
    r = refs.float()
    q2 = (q * q).sum(dim=-1)[:, None]
    r2 = (r * r).sum(dim=-1)[None, :]
    return torch.clamp(q2 - 2.0 * (q @ r.T) + r2, min=0.0)
