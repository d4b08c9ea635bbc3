"""Incremental-SVD losses, the counterpart of
``soft_contrastive_learning_tpu/losses/incremental.py``: spectra of a rank
update against the running loss PCA (``PCAState``), which the trainer keeps
on the host (``pca/incremental.py``) and feeds to each step as tensors.

``incremental_s`` stacks, per tuple,

    B = [ diag(s) @ v ;  X - mean(X) ;  sqrt(seen*n/(seen+n)) (mean(X) - m) ]

in fp32 on the device, (T, L+M+1, D), and returns its singular values
through ``ops/spectral.py::svdvals_descending``, with the stack's Gram (of
the smaller side) formed in float64 and solved in float64, then cast back.
At the defaults (L = loss_dim = 512, M = 12 or 13) the Gram is (2, 525,
525) or (2, 526, 526), and the solve waits for the host. The mm variants
take the smallest of the top ``loss_dim`` values, which at 512 lies in the
tail of the loss PCA's spectrum, among near neighbours: an fp32 Gram (the
JAX package's) rounds its eigenvalue by more than their spacing, and its
gradient came out 0.70 of its largest entry off a float64 evaluation on the
card (``chip_smoke.py``'s ``losses`` phase, H100).

The det variants multiply up to ``loss_dim`` singular values in fp32
(``stable_prod``, ``exp`` of a sum of logs): the product is inf once their
geometric mean passes ~1.19 at 512 values and 0 below ~0.84, as in the JAX
package; the loss is then NaN or the margin with no gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from soft_contrastive_learning_torch.ops.spectral import stable_prod, svdvals_descending


class PCAState(NamedTuple):
    """The running loss PCA as the step is fed it."""

    s: torch.Tensor  # (L,) singular values
    v: torch.Tensor  # (L, D) components
    m: torch.Tensor  # (D,) mean
    seen: torch.Tensor  # () effective samples seen


def incremental_s(x: torch.Tensor, state: PCAState) -> torch.Tensor:
    """Singular values of the incremental-SVD update matrix of (T, M, D)
    observations, (T, min(L+M+1, D)), descending."""
    t, m_rows, _ = x.shape
    mx = x.mean(dim=1, keepdim=True)  # (T, 1, D)
    sv = (state.s[:, None] * state.v)[None].expand(t, -1, -1)  # (T, L, D)
    mean_row = torch.sqrt(state.seen * m_rows / (state.seen + m_rows)) * (mx - state.m)
    stack = torch.cat([sv, x - mx, mean_row], dim=1)
    return svdvals_descending(stack.double()).to(stack.dtype)


def _sliced_spectra(inc_pos: torch.Tensor, inc_neg: torch.Tensor, dimensions: int,
                    scale: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``dimensions`` values (at most all but one), optionally
    divided by the largest negative value."""
    k = min(dimensions, inc_pos.shape[-1] - 1)
    pos_s, neg_s = inc_pos[:, :k], inc_neg[:, :k]
    if scale:
        max_neg = inc_neg[:, :1]
        pos_s, neg_s = pos_s / max_neg, neg_s / max_neg
    return pos_s, neg_s


def _residual_spectra(anchor, positives, negatives, state, dimensions, scale):
    pos_res, neg_res = positives - anchor, negatives - anchor
    residuals = torch.cat([pos_res, neg_res], dim=1)
    spectra = _sliced_spectra(incremental_s(pos_res, state), incremental_s(neg_res, state),
                              dimensions, scale)
    return spectra, residuals.reshape(-1, residuals.shape[-1])


def _member_spectra(anchor, positives, negatives, state, dimensions, scale):
    pos = torch.cat([anchor, positives], dim=1)
    neg = torch.cat([anchor, negatives], dim=1)
    return _sliced_spectra(incremental_s(pos, state), incremental_s(neg, state),
                           dimensions, scale)


def _det(pos_s, neg_s, margin):
    return (stable_prod(pos_s) - stable_prod(neg_s) + margin).mean()


def _mm(pos_s, neg_s, margin):
    return (pos_s.max(dim=1).values - neg_s.min(dim=1).values + margin).mean()


def incremental_residual_det_loss(anchor, positives, negatives, margin: float, state: PCAState,
                                  dimensions: int = 10, scale: bool = False):
    """Det hinge on the incremental spectra of the anchor residuals; also
    returns the flattened residuals, the loss PCA's next update."""
    (pos_s, neg_s), residuals = _residual_spectra(anchor, positives, negatives, state,
                                                  dimensions, scale)
    return _det(pos_s, neg_s, margin), residuals


def incremental_residual_mm_loss(anchor, positives, negatives, margin: float, state: PCAState,
                                 dimensions: int = 10, scale: bool = False):
    """Largest positive against smallest negative value of the residuals'
    incremental spectra; also returns the flattened residuals."""
    (pos_s, neg_s), residuals = _residual_spectra(anchor, positives, negatives, state,
                                                  dimensions, scale)
    return _mm(pos_s, neg_s, margin), residuals


def incremental_det_loss(anchor, positives, negatives, margin: float, state: PCAState,
                         dimensions: int = 10, scale: bool = False):
    """Det hinge on the incremental spectra of {anchor, positives} and
    {anchor, negatives}."""
    return _det(*_member_spectra(anchor, positives, negatives, state, dimensions, scale),
                margin)


def incremental_mm_loss(anchor, positives, negatives, margin: float, state: PCAState,
                        dimensions: int = 10, scale: bool = False):
    """The min/max variant of ``incremental_det_loss``."""
    return _mm(*_member_spectra(anchor, positives, negatives, state, dimensions, scale),
               margin)
