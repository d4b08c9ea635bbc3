"""The shipped flagship serving configuration, the counterpart of
``soft_contrastive_learning_tpu/flagship.py``.

VGG16 + NetVLAD-64 on 180x240 images, a 32,768-D descriptor, the committed
trained weights (``models/weights.py``; a seed-0 init where the artifact is
absent). On a CUDA card the shipped forward is the int8-PTQ path
(``models/quant.py``: Q1 convs, K1 NetVLAD), calibrated once on
``calibration_images``, as JAX builds it on its accelerator; on the CPU it
is the bf16 float path. ``int8_gate`` certifies the quantized path against
the float path on the same parameters: mean descriptor cosine above
``INT8_COSINE_THRESHOLD``, compared as ``not (cos > t)`` so that a NaN fails.

``SERVING_BATCH`` and ``BF16_CONFIRM_BATCH`` are JAX's constants, kept so
that the benchmark asks the same configurations; where the card's own batch
knee lies is an open question of the port's PERF.md. Not ported:
``SERVING_COMPILER_OPTIONS`` (a TPU compiler flag) and
``save_trained_params`` (an export tool of the JAX training runs).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import ModelConfig, resolve_device

SERVING_BATCH = 1536
BF16_CONFIRM_BATCH = 512
# the int8 path ships only if its descriptors match the float path to this
# mean cosine on the calibration batch
INT8_COSINE_THRESHOLD = 0.999


class Int8GateError(RuntimeError):
    """The int8 descriptor missed ``INT8_COSINE_THRESHOLD``: the quantized
    path is not certified on these parameters. Its own type, so that the
    benchmark can record this one failure and let a failed build or launch
    of a kernel stop it."""


def flagship_model_config() -> ModelConfig:
    """The flagship architecture: VGG16 + NetVLAD-64 (K1 on the card), bf16
    compute. (JAX's ``use_pallas`` argument chose between its two NetVLAD
    aggregations on the TPU; the port's counterpart of both is K1.)"""
    return ModelConfig(vlad_cores=64, reduction="none", compute_dtype="bfloat16")


def calibration_images(cfg: ModelConfig, n: int = 8) -> np.ndarray:
    """Deterministic calibration/example batch (uniform [0, 255) pixels),
    JAX's values."""
    return (np.random.default_rng(0)
            .random((n, cfg.image_height, cfg.image_width, 3), np.float32) * 255.0)


def flagship_params(cfg: ModelConfig) -> Tuple[Dict[str, torch.Tensor], str]:
    """(state_dict, provenance): the committed trained artifact when present
    (``"trained"``), else a seed-0 init (``"seed0"``)."""
    from soft_contrastive_learning_torch.models.model import init_params
    from soft_contrastive_learning_torch.models.weights import (
        TRAINED_PARAMS_PATH, load_trained_params)

    if TRAINED_PARAMS_PATH.exists():
        return load_trained_params(None, cfg), "trained"
    return init_params(cfg, 0), "seed0"


def int8_serving(cfg: ModelConfig, params, calib=None, device="cuda"):
    """Calibrated int8-PTQ forward on ``device``: ``(q_embed_fn, scales)``,
    ``q_embed_fn(images) -> (B, D)`` descriptors (the reduced output)."""
    from soft_contrastive_learning_torch.models.quant import QuantizedEmbedder

    if calib is None:
        calib = calibration_images(cfg)
    embedder = QuantizedEmbedder(cfg, params, calib, device=resolve_device(device))
    return embedder, embedder.scales


def descriptor_cosine(a, b) -> float:
    """Mean per-row cosine between two (B, D) descriptor arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean(np.sum(a * b, -1)
                         / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)))


def float_forward(cfg: ModelConfig, params, device="cuda"):
    """The float path: ``EmbeddingNet`` on ``device``, images -> output."""
    from soft_contrastive_learning_torch.models.model import EmbeddingNet
    from soft_contrastive_learning_torch.train.step import build_embed_step

    model = EmbeddingNet(cfg)
    model.load_state_dict(params)
    step = build_embed_step(model.to(resolve_device(device)))
    return lambda images: step(images)[0]


def int8_gate(cfg: ModelConfig, params, calib=None, device="cuda"):
    """Certify the quantized path against the float path on the SAME
    parameters and images. Returns ``(q_embed_fn, scales, cosine)``; raises
    ``Int8GateError`` unless the mean descriptor cosine on the calibration batch
    is above ``INT8_COSINE_THRESHOLD`` (``not (cos > t)``: NaN fails)."""
    if calib is None:
        calib = calibration_images(cfg)
    q_embed, scales = int8_serving(cfg, params, calib, device)
    x = torch.as_tensor(np.asarray(calib)).to(resolve_device(device))
    q = q_embed(x).float().cpu().numpy()
    ref = float_forward(cfg, params, device)(x).float().cpu().numpy()
    cos = descriptor_cosine(q, ref)
    if not (cos > INT8_COSINE_THRESHOLD):
        raise Int8GateError(f"int8 quality gate failed (cosine {cos:.6f}, threshold "
                           f"{INT8_COSINE_THRESHOLD})")
    return q_embed, scales, cos


def serving_forward(device="cuda", params=None):
    """Build the SHIPPED flagship forward: ``(embed_fn, params, detail)``,
    ``embed_fn(images) -> (B, 32768)`` descriptors. On a CUDA device the
    int8-PTQ path (calibrated here, once); on the CPU the bf16 float path.
    ``detail`` records the precision and the parameters' provenance."""
    cfg = flagship_model_config()
    provenance = None
    if params is None:
        params, provenance = flagship_params(cfg)
    detail = {"params": provenance or "caller-supplied"}
    device = resolve_device(device)
    if device.type == "cuda":
        embed_fn, _scales = int8_serving(cfg, params, device=device)
        detail["precision"] = "int8-ptq"
        return embed_fn, params, detail
    detail["precision"] = "bf16"
    return float_forward(cfg, params, device), params, detail
