"""Distance computations, the counterpart of
``soft_contrastive_learning_tpu/ops/distances.py`` (what retrieval needs)."""

from __future__ import annotations

import torch


def cross_sq_dists(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (R, D) -> (Q, R) squared L2 distances via one fp32 product,
    clamped at 0.

    The q^2 - 2qr + r^2 expansion cancels catastrophically in fp32 for
    large-magnitude inputs; use it for unit-scale embeddings. On CUDA it
    assumes ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's
    default."""
    q = queries.float()
    r = refs.float()
    q2 = (q * q).sum(dim=-1)[:, None]
    r2 = (r * r).sum(dim=-1)[None, :]
    return torch.clamp(q2 - 2.0 * (q @ r.T) + r2, min=0.0)
