"""Eigenvalue, trace and residual-SVD losses and the paper's weighted
residual determinant family (swrd, wrd, prodwrd, sumwrd), own copy of
``soft_contrastive_learning_tpu/losses/spectral.py``.

Singular values come from the small-side Gram's eigenvalues
(``ops/spectral.py``): the values of an SVD, with gradients finite at
degenerate spectra.
"""

from __future__ import annotations

import torch

from soft_contrastive_learning_torch.ops.spectral import (
    gram_trace,
    max_eigenvalues,
    min_eigenvalues,
    stable_prod,
    top_svdvals,
)
from soft_contrastive_learning_torch.pca.whiten import fp32_matmuls


def neg_eigenvalue_loss(anchor, negatives) -> torch.Tensor:
    """Maximize the smallest Gram eigenvalue of {anchor, negatives}; the
    negative half of the PN losses, beside ``pairwise_distance_loss``."""
    return -min_eigenvalues(torch.cat([anchor, negatives], dim=1)).mean()


def ntuplet_evmm_loss(anchor, positives, negatives, margin: float) -> torch.Tensor:
    """Hinge between the positive set's smallest and the negative set's
    largest Gram eigenvalue."""
    pos = torch.cat([anchor, positives], dim=1)
    neg = torch.cat([anchor, negatives], dim=1)
    return torch.clamp(margin + min_eigenvalues(pos) - max_eigenvalues(neg), min=0.0).mean()


def ntuplet_trace_loss(anchor, positives, negatives, margin: float) -> torch.Tensor:
    """Hinge between the positive and the negative set's Gram traces."""
    pos = torch.cat([anchor, positives], dim=1)
    neg = torch.cat([anchor, negatives], dim=1)
    return torch.clamp(margin + gram_trace(pos) - gram_trace(neg), min=0.0).mean()


def _residual_spectra(anchor, positives, negatives, dimensions: int):
    """Top singular values of the positive and negative residual matrices."""
    return (top_svdvals(positives - anchor, dimensions),
            top_svdvals(negatives - anchor, dimensions))


def residual_det_loss(anchor, positives, negatives, margin: float, dimensions: int = 10):
    """prod(top-k singular values of the positive residuals) - prod(those of
    the negatives) + margin. The reference adds the margin and applies no
    hinge; kept."""
    pos_s, neg_s = _residual_spectra(anchor, positives, negatives, dimensions)
    return (stable_prod(pos_s) - stable_prod(neg_s) + margin).mean()


def residual_trace_loss(anchor, positives, negatives, margin: float, dimensions: int = 10):
    """The sum-of-singular-values variant."""
    pos_s, neg_s = _residual_spectra(anchor, positives, negatives, dimensions)
    return (pos_s.sum(dim=1) - neg_s.sum(dim=1) + margin).mean()


def _weighted_det_gap(pos_res, neg_res, margin: float, dimensions: int) -> torch.Tensor:
    pos_s = top_svdvals(pos_res, dimensions)
    neg_s = top_svdvals(neg_res, dimensions)
    return (stable_prod(pos_s) - stable_prod(neg_s) + margin).mean()


def swrd_loss(anchor, positives, negatives, pos_weights, neg_weights, margin: float,
              dimensions: int = 10):
    """Separately weighted residual determinant: the positive residuals
    scaled by w+, the negative ones by w-; the weights are the sampler's
    geometric sigmoids, (T, P, 1) and (T, N, 1)."""
    return _weighted_det_gap((positives - anchor) * pos_weights,
                             (negatives - anchor) * neg_weights, margin, dimensions)


def wrd_loss(anchor, positives, negatives, pos_weights, neg_weights, margin: float,
             dimensions: int = 10):
    """Weighted residual determinant over all residuals: every tuple member
    enters both spectra, weighted by its soft positive and negative
    geometric weight, (T, P+N, 1) each."""
    all_res = torch.cat([positives - anchor, negatives - anchor], dim=1)
    return _weighted_det_gap(all_res * pos_weights, all_res * neg_weights, margin, dimensions)


def _feature_similarity_weights(anchor, others, f_alpha_p: float, f_alpha_n: float,
                                f_lamb: float):
    """Sigmoid weights of the anchor-to-member feature similarity, (T, M, 1)
    each: fw+ decays with similarity above f_lamb, fw- grows with it.
    ``torch.sigmoid`` as JAX's ``jax.nn.sigmoid``: finite gradients at
    saturation, where the naive 1/(1+exp(-x)) NaNs."""
    with fp32_matmuls():
        sims = (anchor @ others.transpose(1, 2))[:, 0]  # (T, M)
    fw_pos = torch.sigmoid(-f_alpha_p * (sims - f_lamb))
    fw_neg = torch.sigmoid(-f_alpha_n * (f_lamb - sims))
    return fw_pos[:, :, None], fw_neg[:, :, None]


def prodwrd_loss(anchor, positives, negatives, pos_weights, neg_weights, margin: float,
                 dimensions: int = 10, f_alpha_p: float = 2.0, f_alpha_n: float = 50.0,
                 f_lamb: float = 1.0):
    """wrd with the geometric weights multiplied by the feature-similarity
    weights."""
    all_others = torch.cat([positives, negatives], dim=1)
    all_res = all_others - anchor
    fw_pos, fw_neg = _feature_similarity_weights(anchor, all_others, f_alpha_p, f_alpha_n,
                                                 f_lamb)
    return _weighted_det_gap(all_res * pos_weights * fw_pos, all_res * neg_weights * fw_neg,
                             margin, dimensions)


def sumwrd_loss(anchor, positives, negatives, pos_weights, neg_weights, margin: float,
                dimensions: int = 10, f_alpha_p: float = 2.0, f_alpha_n: float = 50.0,
                f_lamb: float = 1.0):
    """wrd with the geometric and feature-similarity weights added."""
    all_others = torch.cat([positives, negatives], dim=1)
    all_res = all_others - anchor
    fw_pos, fw_neg = _feature_similarity_weights(anchor, all_others, f_alpha_p, f_alpha_n,
                                                 f_lamb)
    return _weighted_det_gap(all_res * (pos_weights + fw_pos), all_res * (neg_weights + fw_neg),
                             margin, dimensions)
