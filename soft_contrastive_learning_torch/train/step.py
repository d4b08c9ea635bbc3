"""The train, eval-loss and embed steps, the counterpart of
``soft_contrastive_learning_tpu/train/step.py``.

The JAX steps are pure jitted functions of (state, batch); here the model
and optimizer hold the state and a step updates them in place. Batch
contract (tensors on the model's device):
  images           (B, H, W, 3) uint8 or float RGB in [0, 255]
  image_idx        (B,) int rows of the device image pool (pooled variant)
  epoch            float, drives the LR schedule
  payload          the loss's geometric arrays (``_PAYLOAD_KEYS``, built by
                   ``sampling/tuples.py`` for its ``distance_type``)
  pca_components/pca_mean/pca_variance   with ``reduction='pca'``: the
                   streaming PCA's (out_dim, D) components, (D,) mean and
                   (out_dim,) variance, which project ``full_out``
  loss_pca_{s,v,m,seen}                  with an incremental loss: the loss
                   PCA's state (``losses/incremental.py::PCAState``)

optax maps onto torch as: ``optax.adam`` -> ``torch.optim.Adam(betas=(0.9,
0.999), eps=1e-8)``, the same ``lr * m_hat / (sqrt(v_hat) + eps)`` update;
``optax.sgd(momentum=m)`` -> ``torch.optim.SGD(momentum=m, dampening=0,
nesterov=False)``. The learning rate is written into ``param_groups`` each
step. ``TrainState.rng`` is a ``torch.Generator`` on the model's device,
seeded from ``cfg.seed``: the dense heads' dropout masks come from it (the
JAX state's dropout key; the draws differ).

``build_train_step_scan`` is the K-step dispatch, JAX's ``lax.scan`` of K
steps in one jitted call: the batch leaves come stacked to (K, ...) in one
transfer, the K steps run as a Python loop over ``build_train_step``'s
step, and the metrics come back stacked, so K grouped steps are K single
steps, bit for bit. On a relay-attached TPU the fusion paid for the
per-call floors; here each step is still launched op by op, and the group
is the unit that a CUDA graph would capture.

A step's metrics carry the streaming PCAs' next updates as JAX's do:
``pca_in`` (``full_out``, detached) with ``reduction='pca'``, and
``loss_pca_in`` (the loss's ``pca_in``, detached) with an incremental loss;
the trainer folds them in on the host.

The PN losses (``LossConfig.pn_loss``) take two updates a step, as JAX's
step does: the pos part's gradient and one optimizer update, then a fresh
forward at the updated weights, the neg part's gradient and a second
update. Both share the optimizer's state, so Adam's per-parameter ``step``
advances twice, as optax's count does; ``TrainState.step`` advances once.
Both forwards draw the same dropout masks, as JAX's share one key.

``mesh=`` (``parallel/mesh.py``) runs a step on the ranks of a data axis,
as JAX's jitted step runs one global program over a sharded batch: each
rank holds its rows of the per-image leaves (``images`` or ``image_idx``,
cut by ``shard_batch``) and the whole of everything else; it runs the
forward on its rows, ``gather_rows`` hands every rank the global (B, D)
output (and ``full_out`` with ``reduction='pca'``, whose projection then
runs on the whole batch), every rank computes the one global loss, and
after the backward ``all_reduce_grads`` sums the ranks' gradients, so that
every rank's optimizer takes the same update from the same bits. The PN
step gathers once per forward. The embed step takes a rank's rows and
returns the whole batch's descriptors on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from soft_contrastive_learning_torch.core.config import TrainConfig, check_batch_divides
from soft_contrastive_learning_torch.losses.incremental import PCAState
from soft_contrastive_learning_torch.losses.registry import LossFn, LossResult, split_batch
from soft_contrastive_learning_torch.models.heads import apply_pca_projection
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_grads,
    gather_rows,
)
from soft_contrastive_learning_torch.train.schedule import learning_rate

_PAYLOAD_KEYS = ("sq_pos_geo_dists", "sq_neg_geo_dists", "pairwise_sq_geo_dists",
                 "pos_weights", "neg_weights", "geo_dist_matrix")


@dataclass
class TrainState:
    model: EmbeddingNet
    optimizer: torch.optim.Optimizer
    step: int = 0
    rng: Optional[torch.Generator] = None  # dropout masks


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam | SGD-momentum at ``cfg.base_lr``; the step rewrites the lr."""
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=cfg.base_lr, momentum=cfg.momentum,
                               dampening=0.0, nesterov=False)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def init_train_state(cfg: TrainConfig, model: EmbeddingNet) -> TrainState:
    device = next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(cfg.seed)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()), rng=rng)


def _forward(cfg: TrainConfig, model: EmbeddingNet, batch: Dict[str, torch.Tensor], train: bool,
             generator: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, full_out) of the whole batch, with the PCA projection of
    ``reduction='pca'``. On a mesh the forward runs on this rank's rows of
    ``images`` and the rows are gathered (with a gradient), ``full_out``
    where the projection or the streaming PCA needs it."""
    shard = (mesh.rank, mesh.size) if mesh is not None and mesh.group is not None else None
    output, full_out = model(batch["images"], train=train, generator=generator, shard=shard)
    if shard is not None:
        if cfg.model.reduction == "pca":
            full_out = gather_rows(full_out, mesh)
        else:
            output = gather_rows(output, mesh)
    if cfg.model.reduction == "pca":
        output = apply_pca_projection(full_out, batch["pca_components"], batch["pca_mean"],
                                      batch["pca_variance"])
    return output, full_out


def _loss_from_output(cfg: TrainConfig, loss_fn: LossFn, output: torch.Tensor,
                      batch: Dict[str, torch.Tensor], **part) -> LossResult:
    tb = split_batch(output, cfg.tuples_per_batch, cfg.tuple_shape)
    state = None
    if cfg.loss.incremental:
        seen = batch["loss_pca_seen"]
        if not torch.is_tensor(seen):  # a fill on the device: no copy, no wait
            seen = torch.full((), seen, dtype=torch.float32, device=output.device)
        state = PCAState(s=batch["loss_pca_s"], v=batch["loss_pca_v"], m=batch["loss_pca_m"],
                         seen=seen)
    payload = {k: batch[k] for k in _PAYLOAD_KEYS if k in batch}
    return loss_fn(tb, payload, state, **part)


def build_train_step(
    cfg: TrainConfig, loss_fn: LossFn, image_pool: bool = False, mesh: Optional[Mesh] = None
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch[, pool]) -> (state, metrics)``: forward, loss,
    backward and one optimizer update (two for the PN losses), in place.
    ``metrics['loss']`` (and the PN losses' ``loss_pos`` and ``loss_neg``,
    the PCA feeds ``pca_in`` and ``loss_pca_in``) stay device tensors (no
    host sync); ``metrics['learning_rate']`` is a float.

    ``image_pool=True`` is the device-resident-pool variant: the batch
    carries ``image_idx`` instead of ``images``, and the step gathers its
    images from the uint8 pool on the device (``data/device_pool.py``).
    ``mesh``: the step of one rank of the data axis (module docstring); the
    batch holds this rank's rows of ``images`` or ``image_idx``."""
    if mesh is not None:
        check_batch_divides(cfg.images_per_batch, mesh.size)

    def update(state: TrainState, batch: Dict[str, torch.Tensor], which: str):
        output, full_out = _forward(cfg, state.model, batch, True, state.rng, mesh)
        part = {} if which == "total" else {"part": which}  # a PN update computes its part only
        res = _loss_from_output(cfg, loss_fn, output, batch, **part)
        value = getattr(res, which)
        state.optimizer.zero_grad(set_to_none=True)
        value.backward()
        all_reduce_grads(state.model.parameters(), mesh)
        state.optimizer.step()
        return value.detach(), res, full_out

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             pool: Optional[torch.Tensor] = None):
        if image_pool:
            batch = dict(batch, images=pool.index_select(0, batch["image_idx"]))
        lr = learning_rate(cfg, float(batch["epoch"]))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.model.train()
        if cfg.loss.pn_loss:
            masks = state.rng.get_state()
            loss_pos, _, _ = update(state, batch, "pos")
            state.rng.set_state(masks)  # the neg part's forward draws the pos part's masks
            # a fresh forward at the updated weights
            loss_neg, res, full_out = update(state, batch, "neg")
            metrics = {"loss": loss_pos + loss_neg, "loss_pos": loss_pos, "loss_neg": loss_neg}
        else:
            loss, res, full_out = update(state, batch, "total")
            metrics = {"loss": loss}
        if cfg.model.reduction == "pca":
            metrics["pca_in"] = full_out.detach()
        if cfg.loss.incremental and res.pca_in is not None:
            metrics["loss_pca_in"] = res.pca_in.detach()
        state.step += 1
        return state, {**metrics, "learning_rate": lr}

    return step


def build_train_step_scan(
    cfg: TrainConfig, loss_fn: LossFn, image_pool: bool = False, mesh: Optional[Mesh] = None
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``scan(state, stacked[, pool]) -> (state, metrics)``: K train steps
    on the K batches of ``stacked``, whose every leaf is stacked to (K, ...)
    (``epoch`` a host array of K values, the rest tensors on the device;
    on a mesh this rank's rows along axis 1, ``shard_batch_stacked``). The
    steps are ``build_train_step``'s, in order, each at its own epoch's
    learning rate. ``metrics`` holds (K,) device tensors, fetched by no one
    here: ``loss`` (with the PN losses' ``loss_pos`` and ``loss_neg``) and
    ``learning_rate`` (float64, the single step's Python floats). As JAX's,
    it refuses the configurations that feed host state back every step (an
    incremental loss, ``reduction='pca'``): their steps run singly."""
    assert not cfg.loss.incremental and cfg.model.reduction != "pca", (
        "fused multi-step dispatch requires a loop with no per-step host state feedback "
        "(incremental losses / pca reduction excluded)")
    step = build_train_step(cfg, loss_fn, image_pool=image_pool, mesh=mesh)

    def scan(state: TrainState, stacked: Dict[str, object],
             pool: Optional[torch.Tensor] = None):
        epochs = [float(e) for e in stacked["epoch"]]
        per_step = []
        for i, epoch in enumerate(epochs):
            batch = {k: epoch if k == "epoch" else v[i] for k, v in stacked.items()}
            state, metrics = step(state, batch, pool)
            per_step.append(metrics)
        lrs = [m.pop("learning_rate") for m in per_step]
        out = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
        out["learning_rate"] = torch.tensor(lrs, dtype=torch.float64, device=out["loss"].device)
        return state, out

    return scan


def build_eval_loss_step(cfg: TrainConfig, model: EmbeddingNet, loss_fn: LossFn,
                         mesh: Optional[Mesh] = None):
    """Held-out loss: forward in eval mode, no update. ``loss`` is the total
    (pos + neg for the PN losses, which also give ``loss_pos`` and
    ``loss_neg``). ``mesh``: each rank embeds its rows of ``images``, and
    the loss is the global batch's on every rank."""

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        output, _ = _forward(cfg, model, batch, False, mesh=mesh)
        res = _loss_from_output(cfg, loss_fn, output, batch)
        if cfg.loss.pn_loss:
            return {"loss": res.total, "loss_pos": res.pos, "loss_neg": res.neg}
        return {"loss": res.total}

    return step


def build_embed_step(
    model: EmbeddingNet, mesh: Optional[Mesh] = None
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Batch descriptor extraction: images -> (output, full_out), with no
    autograd state recorded and no PCA projection (the caller whitens, as
    JAX's). The model carries its config and parameters, which the JAX step
    takes as arguments. The forward runs in eval mode by its ``train=False``
    argument and leaves the module's ``training`` flag alone (no forward
    reads it): the live model of a training run is embedded between steps,
    and by the async mining worker's twin while steps run. ``mesh``:
    ``images`` are this rank's rows (``shard_batch``), and both outputs come
    back gathered, the whole batch's on every rank."""

    @torch.inference_mode()
    def embed(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        output, full_out = model(images, train=False)
        if mesh is None or mesh.group is None:
            return output, full_out
        gathered = all_gather_rows(output, mesh)
        return gathered, gathered if full_out is output else all_gather_rows(full_out, mesh)

    return embed
