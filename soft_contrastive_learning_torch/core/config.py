"""Typed configuration, own copy of
``soft_contrastive_learning_tpu/core/config.py`` (``ModelConfig``,
``TupleConfig``, ``LossConfig``, ``TrainConfig``, ``unique_out_dir``; the
port imports nothing of the JAX package): the fields the port reads, with
the JAX names and defaults. Defaults are the flagship: VGG16 + NetVLAD-64
at 180x240, bf16 convs, raw 32,768-D descriptor, wms loss over 2 tuples of
1+12+12 with Adam at 5e-6. ``use_kernels`` is the counterpart of
``use_pallas``: the NetVLAD aggregation goes through the hand-written CUDA
kernel on a CUDA device. ``winograd`` and ``packed_stem`` (the width-packed
block1, ``ops/packed_stem.py``, in the float and the int8 stack) have the
JAX fields' meanings.

Every ``reduction`` (none | 1fc | 2fc | 3fc | pca | spp), ``vlad_cores=0``
and all 33 losses construct, and ``async_mining`` (the trainer's
worker-thread mining refresh). ``steps_per_dispatch=K`` groups K train
steps into one dispatch (``train/step.py::build_train_step_scan``); with an
incremental loss or ``reduction='pca'`` every step runs singly, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch

# the losses that need the host-side streaming-PCA state (the loss PCA)
INCREMENTAL_LOSSES = ("incremental_residual_det", "incremental_det",
                      "incremental_residual_mm", "incremental_mm")
REDUCTIONS = ("none", "1fc", "2fc", "3fc", "pca", "spp")


def _derive_distance_type(loss: str) -> str:
    """The host-side distance payload a loss needs. Order matters:
    'pairwise' before 'distance', 'swrd' before 'wrd'."""
    if "pairwise" in loss:
        return "pairwise"
    if "distance" in loss:
        return "anchor"
    if "swrd" in loss:
        return "swrd"
    if "wrd" in loss:
        return "wrd"  # also prodwrd / sumwrd
    if "wms" in loss:
        return "wms"
    if "logratio" in loss:
        return "logratio"
    return "none"


@dataclass(frozen=True)
class ModelConfig:
    """The network: VGG16, then NetVLAD with ``vlad_cores`` clusters (0: the
    flattened conv5_3 map), then the ``reduction`` head: ``1fc``/``2fc``/
    ``3fc`` dense stacks to ``out_dim``, ``pca`` (the streaming PCA's
    whitening projection to ``out_dim``, applied by the train step from the
    trainer's state), ``spp`` (max pooling of the conv5_3 map over
    ``spp_levels`` pyramid levels, in place of NetVLAD). ``remat``
    recomputes each conv block in the backward (``torch.utils.checkpoint``)
    in place of keeping its activations."""

    vlad_cores: int = 64
    reduction: str = "none"
    out_dim: int = 512
    spp_levels: int = 3
    image_height: int = 180
    image_width: int = 240
    channels: int = 3
    compute_dtype: str = "bfloat16"  # activations dtype for the conv stack
    param_dtype: str = "float32"
    use_kernels: bool = True  # NetVLAD aggregation through K1 on CUDA
    remat: bool = False
    # The convs whose INPUT channel count is a multiple of 128 (conv2_2 to
    # conv5_3, 10 of the 13) go through the fused Winograd F(2x2,3x3) kernel
    # K4 (ops/kernels/winograd.py): bf16 operands and a bf16 input transform
    # whatever the compute dtype. The JAX field's rule, kept so that both
    # packages send the same layers through that arithmetic. Same parameter
    # tree, so one set of weights serves both configurations.
    winograd: bool = False
    # Exact width-packed block1 (ops/packed_stem.py), in the float backbone
    # (H and W even) and the int8 stack (H even, W % 4 == 0; models/quant.py);
    # elsewhere the standard stem runs. Opt-in, as in JAX, where it measured
    # slower end to end on the TPU.
    packed_stem: bool = False

    def __post_init__(self):
        if self.reduction not in REDUCTIONS:
            raise ValueError(f"unknown reduction {self.reduction!r}; expected one of "
                             f"{REDUCTIONS}")

    @property
    def descriptor_dim(self) -> int:
        """Raw descriptor dimensionality before reduction."""
        if self.reduction == "spp":
            # SPP over the (H/16, W/16, 512) conv5_3 map: sum_{l<L} 4^l bins x 512
            return sum(4**l for l in range(self.spp_levels)) * 512
        if self.vlad_cores > 0:
            return self.vlad_cores * 512
        return (self.image_height // 16) * (self.image_width // 16) * 512  # the flattened map

    @property
    def output_dim(self) -> int:
        """Dimensionality after the reduction head."""
        if self.reduction in ("1fc", "2fc", "3fc", "pca"):
            return self.out_dim
        return self.descriptor_dim


@dataclass(frozen=True)
class TupleConfig:
    """Tuple geometry for the sampler."""

    positives_per_tuple: int = 12
    negatives_per_tuple: int = 12
    hard_positives_per_tuple: int = 6
    hard_negatives_per_tuple: int = 6
    mutually_exclusive_negs: bool = True
    max_pos_radius: float = 15.0
    min_neg_radius: float = 15.0
    max_yaw_diff: float = 3.141592653589793 / 6.0


@dataclass(frozen=True)
class LossConfig:
    """Loss selection and hyperparameters, the JAX fields with their names
    and defaults. ``alpha``/``beta`` are the geometric sigmoid's steepness
    and midpoint [m] (wms's ``d_alpha``/``d_beta``, the *wrd weights); MS's
    own alpha=2, beta=50 are the functions' defaults. ``margin_1/2`` are the
    hinge margins, ``lam`` the distance-regression weight, ``ms_mining``
    the ms_loss/ms_sum mining switch (wms mines always), ``svd_dimensions``
    the singular values kept by the *rd family, ``d_max_squared`` and
    ``f_max_squared`` the distance losses' scales. ``loss_dim`` is read by
    the incremental family only: the loss PCA's components, and the
    singular values its losses keep. ``fused_wms`` takes the wms forward
    through K3 (``ops/kernels/wms.py``) on a CUDA device."""

    name: str = "wms"
    margin_1: float = 0.1
    margin_2: float = 0.2
    lam: float = 0.5
    alpha: float = 0.8
    beta: float = 15.0
    wfunction: str = "exp"  # exp | lin | tanh
    sumfunction: str = "ms"  # ms | plain
    ms_mining: bool = False
    loss_dim: int = 512
    svd_dimensions: int = 10
    d_max_squared: float = 15.0**2  # max_pos_radius**2
    f_max_squared: float = 2.0
    fused_wms: bool = False

    def __post_init__(self):
        if self.wfunction not in ("exp", "lin", "tanh"):
            raise ValueError(f"unknown wfunction {self.wfunction!r}")
        if self.sumfunction not in ("ms", "plain"):
            raise ValueError(f"unknown sumfunction {self.sumfunction!r}")

    @property
    def distance_type(self) -> str:
        return _derive_distance_type(self.name)

    @property
    def pn_loss(self) -> bool:
        """Two-update alternating pos/neg optimization."""
        return "eigenvalue" in self.name

    @property
    def needs_other_neg(self) -> bool:
        """Quadruplet losses take an extra 'other negative' member."""
        return "quadruplet" in self.name

    @property
    def incremental(self) -> bool:
        return "incremental" in self.name


@dataclass(frozen=True)
class TrainConfig:
    """Training-run configuration: the JAX fields (names and defaults) that
    the port reads. The mesh fields are JAX's: ``num_data_shards`` ranks on
    the data axis (0: every rank of the process group; ``cli train`` reads
    it), whose count must divide ``images_per_batch``, and a model axis of
    ``num_model_shards`` = 1, over which JAX shards nothing. ``forgetting_factor``
    is the streaming PCAs' ``f``; ``async_pca`` folds their updates in on a
    worker thread with lag-2 feeds (``pca/async_updater.py``), where False
    applies each step's update before the next step: two different
    trainings, both the JAX package's. JAX's ``dropout_keep_prob`` is not
    ported: its FC heads read nothing of it and drop at rate 0.5, a
    constant of ``models/heads.py::FCHead`` here."""

    model: ModelConfig = field(default_factory=ModelConfig)
    tuples: TupleConfig = field(default_factory=TupleConfig)
    loss: LossConfig = field(default_factory=LossConfig)

    checkpoint: str = ""
    out_dir: str = ""
    # the prep tree read by data/pipeline.py::FilesystemSource
    img_root: str = ""
    shuffled_root: str = ""
    loc_ref_root: str = ""
    anchor_root: str = ""

    tuples_per_batch: int = 2
    max_epoch: int = 5
    base_lr: float = 5e-6
    minimal_lr: float = 5e-12
    lr_down_factor: float = 0.5
    lr_down_frequency: float = 1.0
    momentum: float = 0.9
    optimizer: str = "adam"  # adam | momentum
    forgetting_factor: float = 0.4
    async_pca: bool = True

    mining_step: int = 250
    mining_cache_size: int = 1000
    async_mining: bool = False
    eval_step: int = 100
    save_step: int = 500
    max_to_keep: int = 1  # rolling checkpoints kept; epoch and part keep all
    num_eval_queries: int = 50
    eval_ref_r: int = 5
    train_ref_r: int = 1

    local_ref_set: str = "train_ref"
    local_query_set: str = "train_query"
    other_ref_set: str = "test_ref"
    other_query_set: str = "test_query"

    device_image_pool: bool = True
    device_pool_max_bytes: int = 4_000_000_000
    steps_per_dispatch: int = 1
    seed: int = 42
    data_axis: str = "data"
    model_axis: str = "model"
    num_data_shards: int = 0  # 0: every rank of the process group
    num_model_shards: int = 1

    def __post_init__(self):
        if self.optimizer not in ("adam", "momentum"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.num_model_shards != 1:
            raise NotImplementedError(
                "num_model_shards must be 1: the JAX package shards nothing over its model "
                "axis, and the port has none")
        if self.num_data_shards > 1:
            check_batch_divides(self.images_per_batch, self.num_data_shards)

    @property
    def tuple_shape(self) -> Tuple[int, ...]:
        """Images per tuple: (anchor, P, N), or (anchor, P, N-1, other) for
        the quadruplet losses, whose last negative becomes the 'other
        negative' so that a tuple keeps its size."""
        p = self.tuples.positives_per_tuple
        n = self.tuples.negatives_per_tuple
        if self.loss.needs_other_neg:
            return (1, p, n - 1, 1)
        return (1, p, n)

    @property
    def images_per_batch(self) -> int:
        return self.tuples_per_batch * sum(self.tuple_shape)

    def encode_name(self) -> str:
        """Hyperparameter-encoding run name, e.g. ``al0.8_be15_ha6_lo-wms_...``."""
        t = self.tuples
        parts = [
            f"al{self.loss.alpha:g}",
            f"be{self.loss.beta:g}",
            f"ha{t.hard_negatives_per_tuple}",
            f"lo-{self.loss.name}",
            f"re-{self.model.reduction}",
            f"vl{self.model.vlad_cores}",
            f"tb{self.tuples_per_batch}",
        ]
        return "_".join(parts)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        d = dict(d)
        if isinstance(d.get("model"), dict):
            d["model"] = ModelConfig(**d["model"])
        if isinstance(d.get("tuples"), dict):
            d["tuples"] = TupleConfig(**d["tuples"])
        if isinstance(d.get("loss"), dict):
            d["loss"] = LossConfig(**d["loss"])
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def check_batch_divides(images_per_batch: int, ranks: int) -> None:
    """Each rank embeds an equal share of a step's images: refuse a batch
    that does not divide over the ranks."""
    if images_per_batch % ranks:
        raise ValueError(
            f"images_per_batch {images_per_batch} does not divide over {ranks} data ranks: each "
            "rank embeds an equal share of the batch (set tuples_per_batch so that "
            "tuples_per_batch * images per tuple is a multiple of the rank count)")


def unique_out_dir(out_root: str, base_name: str) -> str:
    """Auto-increment ``_{k:03d}`` suffix when the dir exists."""
    out_dir = os.path.join(out_root, base_name)
    k = 0
    while os.path.exists(out_dir):
        out_dir = os.path.join(out_root, f"{base_name}_{k:03d}")
        k += 1
    return out_dir


def torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on. A CUDA device without a usable card raises:
    nothing silently runs on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


def indexed_device(device: str | torch.device) -> torch.device:
    """``device`` with a CUDA device's index made explicit: the calling
    thread's current device. CUDA's current device is per host thread (a new
    thread's is cuda:0), so an object that hands work for ``cuda`` to other
    threads (decode pools, HTTP handlers) resolves it where it is made."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
