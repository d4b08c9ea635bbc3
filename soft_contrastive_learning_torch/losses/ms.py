"""Multi-similarity losses, own copy of
``soft_contrastive_learning_tpu/losses/ms.py``: hard-label MS (Wang et al.
CVPR'19, ``ms_loss``), the paper's soft geometrically weighted MS
(``wms_loss``), and the ``ms_det`` / ``ms_sum`` combinations.

``wms_loss`` is the plain PyTorch version of K3 (``ops/kernels/wms.py``)
and the source of K3's backward. Two details keep its gradient equal to
JAX's: the clamp at 0 is ``torch.maximum`` against zeros, which, like
``jnp.maximum``, splits the gradient at a tie where ``clamp`` passes all of
it; and the mining thresholds (row max/min) feed only ``where`` conditions,
so no gradient flows through them.
"""

from __future__ import annotations

import torch

from soft_contrastive_learning_torch.losses.spectral import residual_det_loss
from soft_contrastive_learning_torch.models.vgg16 import l2_normalize


def _at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """fp32, or float64 where the input is (the losses' float64 reference)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _ms_terms(
    sim_mat: torch.Tensor,  # (B, B) similarity, clamped >= 0
    mask_pos: torch.Tensor,  # (B, B) soft positive weights, diagonal subtracted
    mask_neg: torch.Tensor,  # (B, B)
    alpha: float,
    beta: float,
    lamb: float,
    eps: float,
    ms_mining: bool,
    sumfunction: str,
) -> torch.Tensor:
    zero = torch.zeros((), dtype=sim_mat.dtype, device=sim_mat.device)
    pos_mat = sim_mat * mask_pos
    neg_mat = sim_mat * mask_neg

    if ms_mining:
        # keep positives harder than (hardest negative - eps) and negatives
        # harder than (easiest positive + eps)
        max_val = neg_mat.amax(dim=1, keepdim=True)
        tmp_max = pos_mat.amax(dim=1, keepdim=True)
        min_val = ((sim_mat - tmp_max) * mask_pos).amin(dim=1, keepdim=True) + tmp_max
        mask_pos = torch.where(pos_mat < max_val + eps, mask_pos, zero)
        mask_neg = torch.where(neg_mat > min_val - eps, mask_neg, zero)
        pos_mat = sim_mat * mask_pos
        neg_mat = sim_mat * mask_neg

    if sumfunction == "plain":
        pos_term = torch.where(mask_pos > 0.0, pos_mat, zero).sum(dim=1)
        neg_term = torch.where(mask_neg > 0.0, neg_mat, zero).sum(dim=1)
        return (neg_term - pos_term).mean()

    pos_exp = torch.where(mask_pos > 0.0, torch.exp(-alpha * (pos_mat - lamb)), zero)
    neg_exp = torch.where(mask_neg > 0.0, torch.exp(beta * (neg_mat - lamb)), zero)
    pos_term = torch.log1p(pos_exp.sum(dim=1)) / alpha
    neg_term = torch.log1p(neg_exp.sum(dim=1)) / beta
    return (pos_term + neg_term).mean()


def wms_loss(
    geo_distances: torch.Tensor,  # (B, B) metric distances between all batch images
    embeddings: torch.Tensor,  # (B, D)
    d_alpha: float,
    d_beta: float,
    alpha: float = 2.0,
    beta: float = 50.0,
    lamb: float = 1.0,
    eps: float = 0.1,
    ms_mining: bool = True,
    wfunction: str = "exp",
    sumfunction: str = "ms",
) -> torch.Tensor:
    """Soft weighted MS: the binary masks of MS replaced by geometric
    weights of the metric distance matrix.

    wfunction:
      * 'exp' : w+ = sigmoid(-d_alpha (d - d_beta)), w- = sigmoid(-d_alpha (d_beta - d))
      * 'lin' : w+ = max(1 - d/d_beta, 0),           w- = min(d/d_beta, 1)
      * 'tanh': w+ = 1 - tanh(d/d_beta),             w- = tanh(d/d_beta)
    """
    emb = l2_normalize(_at_least_fp32(embeddings), dim=1)
    b = emb.shape[0]
    d = _at_least_fp32(geo_distances)
    if wfunction == "lin":
        mask_pos = torch.where(d < d_beta, 1.0 - d / d_beta, torch.zeros_like(d))
        mask_neg = torch.where(d < d_beta, d / d_beta, torch.ones_like(d))
    elif wfunction == "tanh":
        mask_pos = 1.0 - torch.tanh(d / d_beta)
        mask_neg = torch.tanh(d / d_beta)
    elif wfunction == "exp":
        mask_pos = torch.sigmoid(-d_alpha * (d - d_beta))
        mask_neg = torch.sigmoid(-d_alpha * (d_beta - d))
    else:
        raise ValueError(f"unknown wfunction {wfunction!r}")
    mask_pos = mask_pos - torch.eye(b, dtype=d.dtype, device=d.device)
    sim = torch.maximum(emb @ emb.T, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return _ms_terms(sim, mask_pos, mask_neg, alpha, beta, lamb, eps, ms_mining, sumfunction)


def ms_loss(
    labels: torch.Tensor,  # (B,) integer class labels
    embeddings: torch.Tensor,  # (B, D)
    alpha: float = 2.0,
    beta: float = 50.0,
    lamb: float = 1.0,
    eps: float = 0.1,
    ms_mining: bool = True,
) -> torch.Tensor:
    """Hard-label multi-similarity loss."""
    emb = l2_normalize(_at_least_fp32(embeddings), dim=1)
    b = emb.shape[0]
    labels = labels.to(emb.device).reshape(-1, 1)
    adjacency = labels == labels.T
    mask_pos = adjacency.to(emb.dtype) - torch.eye(b, dtype=emb.dtype, device=emb.device)
    mask_neg = (~adjacency).to(emb.dtype)
    sim = torch.maximum(emb @ emb.T, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return _ms_terms(sim, mask_pos, mask_neg, alpha, beta, lamb, eps, ms_mining, "ms")


def ms_det_loss(labels, embeddings, alpha=2.0, beta=50.0, lamb=1.0, eps=0.1,
                ms_mining=False):
    """ms_loss with mining off by default: the reference keeps it as a
    function of its own, which its training script never dispatches."""
    return ms_loss(labels, embeddings, alpha, beta, lamb, eps, ms_mining)


def ms_sum_loss(
    anchor,
    positives,
    negatives,
    margin: float,
    labels: torch.Tensor,
    embeddings: torch.Tensor,
    alpha: float = 2.0,
    beta: float = 50.0,
    lamb: float = 1.0,
    eps: float = 0.1,
    ms_mining: bool = False,
    dimensions: int = 10,
) -> torch.Tensor:
    """5 * ms + residual_det."""
    ms = ms_loss(labels, embeddings, alpha, beta, lamb, eps, ms_mining)
    return ms * 5.0 + residual_det_loss(anchor, positives, negatives, margin, dimensions)


def tuple_labels(tuples_per_batch: int, positives_per_tuple: int,
                 negatives_per_tuple: int) -> torch.Tensor:
    """Per-image class labels of a tuple batch for ms_loss: the anchor and
    its positives share a class, each negative is a class of its own."""
    one = torch.cat([torch.zeros(1 + positives_per_tuple, dtype=torch.int32),
                     torch.arange(negatives_per_tuple, dtype=torch.int32) + 1])
    offset = negatives_per_tuple + 1
    return torch.cat([one + t * offset for t in range(tuples_per_batch)])
