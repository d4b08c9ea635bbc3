"""PointNetVLAD baseline losses and the 'evil' variants, own copy of
``soft_contrastive_learning_tpu/losses/pointnetvlad.py``.

Hinge losses on *squared* embedding distances. The positive term is the
closest positive, summed over negatives, or maxed over them in the 'lazy'
variants; the 'evil' variants take the farthest positive instead. Shapes:
anchor (T, 1, D), positives (T, P, D), negatives (T, N, D), other_neg
(T, 1, D); scalar output.
"""

from __future__ import annotations

import torch

from soft_contrastive_learning_torch.ops.distances import sq_dists_to_anchor


def best_pos_distance(anchor: torch.Tensor, positives: torch.Tensor) -> torch.Tensor:
    """(T,) squared distance to the closest positive."""
    return sq_dists_to_anchor(anchor, positives).amin(dim=1)


def worst_pos_distance(anchor: torch.Tensor, positives: torch.Tensor) -> torch.Tensor:
    """(T,) squared distance to the farthest positive."""
    return sq_dists_to_anchor(anchor, positives).amax(dim=1)


def _hinge_matrix(pos_term: torch.Tensor, neg_sq_dists: torch.Tensor,
                  margin: float) -> torch.Tensor:
    return torch.clamp(margin + pos_term[:, None] - neg_sq_dists, min=0.0)


def triplet_loss(anchor, positives, negatives, margin: float) -> torch.Tensor:
    neg_d = sq_dists_to_anchor(anchor, negatives)
    return _hinge_matrix(best_pos_distance(anchor, positives), neg_d, margin).sum(dim=1).mean()


def lazy_triplet_loss(anchor, positives, negatives, margin: float) -> torch.Tensor:
    neg_d = sq_dists_to_anchor(anchor, negatives)
    return _hinge_matrix(best_pos_distance(anchor, positives), neg_d, margin).amax(dim=1).mean()


def evil_triplet_loss(anchor, positives, negatives, margin: float) -> torch.Tensor:
    """Triplet with the farthest positive."""
    neg_d = sq_dists_to_anchor(anchor, negatives)
    return _hinge_matrix(worst_pos_distance(anchor, positives), neg_d, margin).sum(dim=1).mean()


def _second_order_term(pos_term, negatives, other_neg, margin2: float,
                       lazy: bool) -> torch.Tensor:
    """Hinge between the positive term and d(negatives, other_neg)."""
    neg_to_other = ((negatives - other_neg) ** 2).sum(dim=-1)  # (T, N)
    h = _hinge_matrix(pos_term, neg_to_other, margin2)
    return (h.amax(dim=1) if lazy else h.sum(dim=1)).mean()


def quadruplet_loss(anchor, positives, negatives, other_neg, margin1: float,
                    margin2: float) -> torch.Tensor:
    trip = triplet_loss(anchor, positives, negatives, margin1)
    best = best_pos_distance(anchor, positives)
    return trip + _second_order_term(best, negatives, other_neg, margin2, lazy=False)


def lazy_quadruplet_loss(anchor, positives, negatives, other_neg, margin1: float,
                         margin2: float) -> torch.Tensor:
    trip = lazy_triplet_loss(anchor, positives, negatives, margin1)
    best = best_pos_distance(anchor, positives)
    return trip + _second_order_term(best, negatives, other_neg, margin2, lazy=True)


def evil_quadruplet_loss(anchor, positives, negatives, other_neg, margin1: float,
                         margin2: float) -> torch.Tensor:
    """Quadruplet with the farthest positive in both hinges."""
    trip = evil_triplet_loss(anchor, positives, negatives, margin1)
    worst = worst_pos_distance(anchor, positives)
    return trip + _second_order_term(worst, negatives, other_neg, margin2, lazy=False)
