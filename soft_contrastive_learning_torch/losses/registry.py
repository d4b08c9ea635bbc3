"""Loss registry, the counterpart of
``soft_contrastive_learning_tpu/losses/registry.py`` with the ``wms``
branch only: ``TupleBatch``, ``LossResult``, ``split_batch`` and
``build_loss``. The other 32 names come with the model/loss-zoo slice.

wms consumes the full-batch (B, B) geographic distance matrix
(``payload["geo_dist_matrix"]``) with MS mining always on. With
``LossConfig.fused_wms`` and the exp/ms configuration, the forward goes
through K3 (``ops/kernels/wms.py::wms_loss_fused``) when the embeddings lie on a
CUDA device; the JAX package takes its Pallas kernel on the TPU backend.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from soft_contrastive_learning_torch.core.config import LossConfig, TupleConfig
from soft_contrastive_learning_torch.losses.ms import wms_loss
from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_fused


class TupleBatch(NamedTuple):
    """The quadruplets' ``other`` member comes with the loss zoo."""

    anchor: torch.Tensor  # (T, 1, D)
    positives: torch.Tensor  # (T, P, D)
    negatives: torch.Tensor  # (T, N, D)
    embeddings: torch.Tensor  # (T * S, D) flat batch, S = sum(tuple_shape)


class LossResult(NamedTuple):
    """The PN losses' pos/neg parts and the incremental losses' PCA feed
    come with the loss zoo."""

    total: torch.Tensor  # scalar


LossFn = Callable[[TupleBatch, Dict[str, torch.Tensor], None], LossResult]


def split_batch(
    embeddings: torch.Tensor, tuples_per_batch: int, tuple_shape: Tuple[int, ...]
) -> TupleBatch:
    """Reshape a flat (T*S, D) embedding batch into its (1, P, N) tuple
    members."""
    _, p, n = tuple_shape
    grouped = embeddings.reshape(tuples_per_batch, 1 + p + n, embeddings.shape[-1])
    return TupleBatch(grouped[:, :1], grouped[:, 1 : 1 + p], grouped[:, 1 + p :], embeddings)


def build_loss(cfg: LossConfig, tuples: TupleConfig, tuples_per_batch: int) -> LossFn:
    """The configured loss as one function of (TupleBatch, payload, state)."""
    if cfg.name != "wms":
        raise NotImplementedError(
            f"loss {cfg.name!r} comes with the model/loss-zoo slice of the port")
    fused_eligible = cfg.fused_wms and cfg.wfunction == "exp" and cfg.sumfunction == "ms"

    def wms_fn(b: TupleBatch, p: Dict[str, torch.Tensor], st=None) -> LossResult:
        geo = p["geo_dist_matrix"]
        if fused_eligible and b.embeddings.device.type == "cuda":
            return LossResult(wms_loss_fused(geo, b.embeddings, cfg.alpha, cfg.beta))
        return LossResult(wms_loss(geo, b.embeddings, d_alpha=cfg.alpha, d_beta=cfg.beta,
                                   ms_mining=True, wfunction=cfg.wfunction,
                                   sumfunction=cfg.sumfunction))

    return wms_fn
