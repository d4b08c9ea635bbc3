"""Loss registry, own copy of ``soft_contrastive_learning_tpu/losses/registry.py``:
``TupleBatch``, ``LossResult``, ``split_batch``, ``build_loss`` and
``LOSS_NAMES``.

Every loss is a function of the split embeddings (``TupleBatch``) and the
sampler's geometric payload for its ``distance_type``, returning a
``LossResult``; the PN losses (two alternating updates, ``train/step.py``)
also return their pos and neg parts, or one of them alone (``part``). All
33 of JAX's names are here. The third argument of a loss is the running
loss PCA (``losses/incremental.py::PCAState``), which only the four
``incremental_*`` losses read (None for the others); they return the loss
PCA's next update as ``pca_in``: the flattened anchor residuals for the
``*_residual_*`` pair, the flat batch for ``incremental_det`` and
``incremental_mm``.

wms consumes the full-batch (B, B) geographic distance matrix
(``payload["geo_dist_matrix"]``) with MS mining always on. With
``LossConfig.fused_wms`` and the exp/ms configuration, the forward goes
through K3 (``ops/kernels/wms.py::wms_loss_fused``) when the embeddings lie on a
CUDA device; the JAX package takes its Pallas kernel on the TPU backend.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from soft_contrastive_learning_torch.core.config import LossConfig, TupleConfig
from soft_contrastive_learning_torch.losses import distance as dist_losses
from soft_contrastive_learning_torch.losses import incremental as inc_losses
from soft_contrastive_learning_torch.losses import ms as ms_losses
from soft_contrastive_learning_torch.losses import pointnetvlad as pnv
from soft_contrastive_learning_torch.losses import spectral as spec
from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_fused


class TupleBatch(NamedTuple):
    anchor: torch.Tensor  # (T, 1, D)
    positives: torch.Tensor  # (T, P, D)
    negatives: torch.Tensor  # (T, N, D)
    other: Optional[torch.Tensor]  # (T, 1, D), the quadruplets' other negative, or None
    embeddings: torch.Tensor  # (T * S, D) flat batch, S = sum(tuple_shape)


class LossResult(NamedTuple):
    total: torch.Tensor  # scalar (pos + neg for the PN losses)
    pos: Optional[torch.Tensor] = None  # PN losses only
    neg: Optional[torch.Tensor] = None  # PN losses only
    pca_in: Optional[torch.Tensor] = None  # the incremental losses' loss-PCA update


# (TupleBatch, payload, PCAState | None) -> LossResult; the PN losses also take ``part``
LossFn = Callable[..., LossResult]


def split_batch(
    embeddings: torch.Tensor, tuples_per_batch: int, tuple_shape: Tuple[int, ...]
) -> TupleBatch:
    """Reshape a flat (T*S, D) embedding batch into its tuple members:
    (1, P, N), or (1, P, N, 1) with the other negative last."""
    grouped = embeddings.reshape(tuples_per_batch, sum(tuple_shape), embeddings.shape[-1])
    parts = torch.split(grouped, list(tuple_shape), dim=1)
    other = parts[3] if len(tuple_shape) == 4 else None
    return TupleBatch(parts[0], parts[1], parts[2], other, embeddings)


def _labels_on(labels: torch.Tensor):
    """ms_loss's labels on the embeddings' device, copied there once."""
    on_device: Dict[torch.device, torch.Tensor] = {}

    def get(device: torch.device) -> torch.Tensor:
        if device not in on_device:
            on_device[device] = labels.to(device)
        return on_device[device]

    return get


def build_loss(cfg: LossConfig, tuples: TupleConfig, tuples_per_batch: int) -> LossFn:
    """The configured loss as one function of (TupleBatch, payload, state)."""
    name = cfg.name
    m1, m2, lam = cfg.margin_1, cfg.margin_2, cfg.lam
    dmax, fmax = cfg.d_max_squared, cfg.f_max_squared
    dims = cfg.svd_dimensions
    lazy = "lazy" in name
    use_huber = "huber" in name

    pnv_triplets = {"triplet": pnv.triplet_loss, "lazy_triplet": pnv.lazy_triplet_loss,
                    "evil_triplet": pnv.evil_triplet_loss}
    if name in pnv_triplets:
        fn = pnv_triplets[name]
        return lambda b, p, st=None: LossResult(fn(b.anchor, b.positives, b.negatives, m1))
    pnv_quadruplets = {"quadruplet": pnv.quadruplet_loss,
                       "lazy_quadruplet": pnv.lazy_quadruplet_loss,
                       "evil_quadruplet": pnv.evil_quadruplet_loss}
    if name in pnv_quadruplets:
        fn = pnv_quadruplets[name]
        return lambda b, p, st=None: LossResult(
            fn(b.anchor, b.positives, b.negatives, b.other, m1, m2))

    if name in ("distance_triplet", "distance_lazy_triplet", "huber_distance_triplet",
                "huber_distance_lazy_triplet"):
        return lambda b, p, st=None: LossResult(dist_losses.distance_triplet_loss(
            b.anchor, b.positives, b.negatives, m1, lam, p["sq_pos_geo_dists"], dmax, fmax,
            lazy=lazy, use_huber=use_huber))
    if name in ("distance_quadruplet", "distance_lazy_quadruplet",
                "huber_distance_quadruplet", "huber_distance_lazy_quadruplet"):
        return lambda b, p, st=None: LossResult(dist_losses.distance_quadruplet_loss(
            b.anchor, b.positives, b.negatives, b.other, m1, m2, lam, p["sq_pos_geo_dists"],
            dmax, fmax, lazy=lazy, use_huber=use_huber))

    if name in ("pairwise_distance_neg_eigenvalue", "pairwise_huber_distance_neg_eigenvalue"):
        def pn_fn(b, p, st=None, part=None):
            """``part`` 'pos' or 'neg' computes that part alone (the other
            is None): the train step's two updates each need one, and the
            neg part's eigensolve waits for the device."""
            pos = neg = None
            if part != "neg":
                pos = dist_losses.pairwise_distance_loss(
                    b.anchor, b.positives, p["pairwise_sq_geo_dists"], dmax, fmax,
                    use_huber=use_huber)
            if part != "pos":
                neg = spec.neg_eigenvalue_loss(b.anchor, b.negatives)
            total = pos + neg if part is None else (pos if part == "pos" else neg)
            return LossResult(total, pos=pos, neg=neg)

        return pn_fn

    if name == "ntuplet_evmm":
        return lambda b, p, st=None: LossResult(
            spec.ntuplet_evmm_loss(b.anchor, b.positives, b.negatives, m1))
    if name == "ntuplet_trace":
        return lambda b, p, st=None: LossResult(
            spec.ntuplet_trace_loss(b.anchor, b.positives, b.negatives, m1))
    if name == "residual_det":
        return lambda b, p, st=None: LossResult(
            spec.residual_det_loss(b.anchor, b.positives, b.negatives, m1, dims))
    if name == "residual_trace":
        return lambda b, p, st=None: LossResult(
            spec.residual_trace_loss(b.anchor, b.positives, b.negatives, m1, dims))

    incremental = {"incremental_residual_det": inc_losses.incremental_residual_det_loss,
                   "incremental_residual_mm": inc_losses.incremental_residual_mm_loss,
                   "incremental_det": inc_losses.incremental_det_loss,
                   "incremental_mm": inc_losses.incremental_mm_loss}
    if name in incremental:
        fn = incremental[name]
        if "residual" in name:
            def residual_fn(b, p, st=None):
                loss, residuals = fn(b.anchor, b.positives, b.negatives, m1, st, cfg.loss_dim)
                return LossResult(loss, pca_in=residuals)

            return residual_fn
        return lambda b, p, st=None: LossResult(
            fn(b.anchor, b.positives, b.negatives, m1, st, cfg.loss_dim), pca_in=b.embeddings)

    if name in ("ms_loss", "ms_det", "ms_sum"):
        labels = _labels_on(ms_losses.tuple_labels(
            tuples_per_batch, tuples.positives_per_tuple, tuples.negatives_per_tuple))
        if name == "ms_loss":
            return lambda b, p, st=None: LossResult(ms_losses.ms_loss(
                labels(b.embeddings.device), b.embeddings, ms_mining=cfg.ms_mining))
        if name == "ms_det":
            # the function's own default, mining off: what sets it apart from ms_loss
            return lambda b, p, st=None: LossResult(ms_losses.ms_det_loss(
                labels(b.embeddings.device), b.embeddings, ms_mining=False))
        return lambda b, p, st=None: LossResult(ms_losses.ms_sum_loss(
            b.anchor, b.positives, b.negatives, m1, labels(b.embeddings.device), b.embeddings,
            ms_mining=cfg.ms_mining, dimensions=dims))

    wrd_family = {"swrd": spec.swrd_loss, "wrd": spec.wrd_loss, "prodwrd": spec.prodwrd_loss,
                  "sumwrd": spec.sumwrd_loss}
    if name in wrd_family:
        fn = wrd_family[name]
        return lambda b, p, st=None: LossResult(fn(
            b.anchor, b.positives, b.negatives, p["pos_weights"], p["neg_weights"], m1, dims))

    if name == "wms":
        fused_eligible = cfg.fused_wms and cfg.wfunction == "exp" and cfg.sumfunction == "ms"

        def wms_fn(b: TupleBatch, p: Dict[str, torch.Tensor], st=None) -> LossResult:
            geo = p["geo_dist_matrix"]
            if fused_eligible and b.embeddings.device.type == "cuda":
                return LossResult(wms_loss_fused(geo, b.embeddings, cfg.alpha, cfg.beta))
            return LossResult(ms_losses.wms_loss(
                geo, b.embeddings, d_alpha=cfg.alpha, d_beta=cfg.beta, ms_mining=True,
                wfunction=cfg.wfunction, sumfunction=cfg.sumfunction))

        return wms_fn

    if name == "logratio":
        return lambda b, p, st=None: LossResult(dist_losses.logratio_loss(
            b.anchor, b.positives, b.negatives, p["sq_pos_geo_dists"], p["sq_neg_geo_dists"]))

    raise ValueError(f"unknown loss: {name!r}")


LOSS_NAMES = (
    "triplet", "lazy_triplet", "evil_triplet",
    "quadruplet", "lazy_quadruplet", "evil_quadruplet",
    "distance_triplet", "distance_lazy_triplet",
    "distance_quadruplet", "distance_lazy_quadruplet",
    "huber_distance_triplet", "huber_distance_lazy_triplet",
    "huber_distance_quadruplet", "huber_distance_lazy_quadruplet",
    "pairwise_distance_neg_eigenvalue", "pairwise_huber_distance_neg_eigenvalue",
    "ntuplet_evmm", "ntuplet_trace",
    "residual_det", "residual_trace",
    "incremental_residual_det", "incremental_det",
    "incremental_residual_mm", "incremental_mm",
    "ms_loss", "ms_det", "ms_sum",
    "swrd", "wrd", "prodwrd", "sumwrd",
    "wms", "logratio",
)
