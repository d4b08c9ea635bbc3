"""Distance-regression hybrid losses and the log-ratio loss, own copy of
``soft_contrastive_learning_tpu/losses/distance.py``.

The losses regress the *scaled squared feature distance* onto the *scaled
squared geographic distance*, each divided by its expected maximum
(``d_max_squared`` = max_pos_radius^2, ``f_max_squared`` = 2.0).
"""

from __future__ import annotations

import torch

from soft_contrastive_learning_torch.losses.pointnetvlad import (
    lazy_triplet_loss,
    triplet_loss,
)
from soft_contrastive_learning_torch.ops.distances import pairwise_sq_dists, sq_dists_to_anchor


def huber(residual: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber (``tf.losses.huber_loss``, delta 1): 0.5 r^2 inside
    the delta, linear outside."""
    abs_r = residual.abs()
    quad = torch.clamp(abs_r, max=delta)
    return 0.5 * quad**2 + delta * (abs_r - quad)


def _scale_distances(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared):
    """(scaled geographic, scaled feature) squared distances, both (T, P)."""
    return sq_geo_dists / d_max_squared, sq_dists_to_anchor(anchor, positives) / f_max_squared


def distance_loss(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared):
    """MSE between the scaled feature and geographic distances."""
    sd, sf = _scale_distances(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared)
    return ((sf - sd) ** 2).mean(dim=1).mean()


def huber_distance_loss(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared):
    """Huber variant (mean over all entries)."""
    sd, sf = _scale_distances(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared)
    return huber(sf - sd).mean()


def _best_distance_term(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared,
                        use_huber: bool):
    """(T,) smallest per-positive regression error."""
    sd, sf = _scale_distances(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared)
    err = huber(sf - sd) if use_huber else (sf - sd) ** 2
    return err.amin(dim=1)


def distance_triplet_loss(anchor, positives, negatives, margin: float, lam: float,
                          sq_geo_dists, d_max_squared: float, f_max_squared: float,
                          lazy: bool = False, use_huber: bool = True):
    """triplet + lam * distance regression."""
    trip = (lazy_triplet_loss if lazy else triplet_loss)(anchor, positives, negatives, margin)
    dist_fn = huber_distance_loss if use_huber else distance_loss
    return trip + lam * dist_fn(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared)


def distance_quadruplet_loss(anchor, positives, negatives, other_neg, margin1: float,
                             margin2: float, lam: float, sq_geo_dists, d_max_squared: float,
                             f_max_squared: float, lazy: bool = False, use_huber: bool = True):
    """distance_triplet + a second-order hinge against the other negative,
    the negative-to-other distance scaled by f_max. The second hinge is
    maxed over the negatives in both variants, as the reference does."""
    trip = distance_triplet_loss(anchor, positives, negatives, margin1, lam, sq_geo_dists,
                                 d_max_squared, f_max_squared, lazy=lazy, use_huber=use_huber)
    best = _best_distance_term(anchor, positives, sq_geo_dists, d_max_squared, f_max_squared,
                               use_huber)  # (T,)
    neg_to_other = ((negatives - other_neg) ** 2).sum(dim=-1) / f_max_squared
    h = torch.clamp(margin2 + best[:, None] - neg_to_other, min=0.0)
    return trip + h.amax(dim=1).mean()


def pairwise_distance_loss(anchor, positives, pairwise_sq_geo_dists, d_max_squared: float,
                           f_max_squared: float, use_huber: bool = False):
    """Regression over all pairs of {anchor, positives}; the geographic
    payload is (T, P+1, P+1)."""
    feats = torch.cat([anchor, positives], dim=1)  # (T, P+1, D)
    sq_f = pairwise_sq_dists(feats) / f_max_squared
    sq_d = pairwise_sq_geo_dists / d_max_squared
    err = huber(sq_f - sq_d) if use_huber else (sq_f - sq_d) ** 2
    return err.mean(dim=2).mean(dim=1).mean()


def logratio_loss(anchor, positives, negatives, sq_pos_geo_dists, sq_neg_geo_dists,
                  eps: float = 1e-12):
    """Log-ratio loss (Kim et al. ICCV'19): log feature-distance ratios
    matched to log geographic-distance ratios over every (positive,
    negative) pair, the explicit (T, P, N) grid."""
    pos_res = sq_dists_to_anchor(anchor, positives)  # (T, P)
    neg_res = sq_dists_to_anchor(anchor, negatives)  # (T, N)
    feat_ratio = torch.log(pos_res[:, :, None] + eps) - torch.log(neg_res[:, None, :] + eps)
    dist_ratio = (torch.log(sq_pos_geo_dists[:, :, None] + eps)
                  - torch.log(sq_neg_geo_dists[:, None, :] + eps))
    return ((feat_ratio - dist_ratio) ** 2).mean(dim=2).mean(dim=1).mean()
