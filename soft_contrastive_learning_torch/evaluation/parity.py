"""Descriptor-level parity harness against the reference TF1 checkpoints.
Own copy of ``soft_contrastive_learning_tpu/evaluation/parity.py``.

The protocol (PARITY.md layer 2): export the released TF1 checkpoint to an
``.npz`` of {tf_name: array} (``models/convert_tf1.py``'s docstring) and,
on a machine with TensorFlow, run the TF1 graph on a folder of images and
save its descriptors as a golden ``.npz`` (``{"descriptors": (N, D),
"files": [...]}``). Then ``cli parity --checkpoint ckpt.npz --images dir/``
converts the weights, warm-starts the EmbeddingNet's ``vgg16`` and
``netvlad`` scopes onto a fresh init, embeds the same images and either
writes the descriptors (``--out``) or, with ``--golden``, compares them
and passes or fails on the max-abs tolerance (exit code 1 on a failure).

It embeds in fp32 with TF32 off and the plain NetVLAD
(``use_kernels=False``), as JAX embeds with ``use_pallas=False``: the
comparison is against the TF1 fp32 graph. It runs on ``device``, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from soft_contrastive_learning_torch.checkpoints.manager import (
    WARM_START_SCOPES,
    warm_start_params,
)
from soft_contrastive_learning_torch.core.config import ModelConfig, resolve_device
from soft_contrastive_learning_torch.models.convert_tf1 import convert_checkpoint, flatten
from soft_contrastive_learning_torch.models.model import EmbeddingNet, init_params
from soft_contrastive_learning_torch.models.weights import flax_param_shapes, params_from_flax
from soft_contrastive_learning_torch.pca.whiten import fp32_matmuls
from soft_contrastive_learning_torch.utils.cv import normalize_geometry
from soft_contrastive_learning_torch.utils.io import IMAGE_EXTENSIONS, load_img


@dataclass
class ParityReport:
    n_images: int
    descriptor_dim: int
    converted_vars: int
    warm_started_scopes: List[str]
    max_abs_diff: Optional[float] = None
    min_cosine: Optional[float] = None
    tolerance: Optional[float] = None
    passed: Optional[bool] = None
    descriptors_path: Optional[str] = None

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def _list_images(images: str) -> List[str]:
    if os.path.isdir(images):
        files = sorted(
            os.path.join(images, f)
            for f in os.listdir(images)
            if f.lower().endswith(IMAGE_EXTENSIONS)
        )
    else:  # newline-separated list file
        with open(images) as fh:
            files = [ln.strip() for ln in fh if ln.strip()]
    if not files:
        raise FileNotFoundError(f"no images found in {images!r}")
    return files


def embed_with_checkpoint(
    checkpoint: str,
    image_files: Sequence[str],
    cfg: Optional[ModelConfig] = None,
    batch_size: int = 16,
    device="cuda",
):
    """convert -> warm-start -> fp32 embed. Returns (descriptors, report).
    Without ``cfg`` the architecture comes from the export (NetVLAD's
    cluster count from ``cluster_centers``, (D, K)), in fp32 with the plain
    NetVLAD."""
    donor, mapping = convert_checkpoint(checkpoint)
    if cfg is None:
        vlad = (int(donor["netvlad"]["cluster_centers"].shape[-1])
                if "netvlad" in donor else 0)
        cfg = ModelConfig(vlad_cores=vlad, reduction="none", compute_dtype="float32",
                          use_kernels=False)
    # the scopes the architecture has: with 'spp' or vlad_cores=0 no NetVLAD
    scopes = {k.split("/")[0] for k in flax_param_shapes(cfg)} & set(WARM_START_SCOPES)
    flat = {k: v for k, v in flatten(donor).items() if k.split("/")[0] in scopes}
    params, copied = warm_start_params(init_params(cfg, 0),
                                       params_from_flax(flat, cfg, partial=True))
    device = resolve_device(device)
    model = EmbeddingNet(cfg)
    model.load_state_dict(params)
    model = model.to(device).eval()

    descs = []
    with torch.inference_mode(), fp32_matmuls(), \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for start in range(0, len(image_files), batch_size):
            chunk = image_files[start : start + batch_size]
            # keep-aspect for NetVLAD models, as the extractor and the
            # reference's NetVLAD preprocessing: a center-crop here would
            # feed other pixels than the TF1 run
            imgs = np.stack([
                normalize_geometry(load_img(f, device), cfg.image_height, cfg.image_width,
                                   keep_aspect=cfg.vlad_cores > 0)
                for f in chunk
            ]).astype(np.float32)
            out, _ = model(torch.from_numpy(imgs).to(device))
            descs.append(out.float().cpu().numpy())
    descriptors = np.concatenate(descs)
    report = ParityReport(
        n_images=len(image_files),
        descriptor_dim=int(descriptors.shape[1]),
        converted_vars=len(mapping),
        warm_started_scopes=list(copied),
    )
    return descriptors, report


def compare_descriptors(
    ours: np.ndarray, golden: np.ndarray, tolerance: float = 1e-3
) -> Dict[str, float]:
    """Max-abs + min-cosine diff between descriptor matrices (same order)."""
    if ours.shape != golden.shape:
        raise ValueError(f"shape mismatch: ours {ours.shape} vs golden {golden.shape}")
    ours64, gold64 = ours.astype(np.float64), golden.astype(np.float64)
    cos = np.sum(ours64 * gold64, -1) / (
        np.linalg.norm(ours64, axis=-1) * np.linalg.norm(gold64, axis=-1) + 1e-30
    )
    return {
        "max_abs_diff": float(np.abs(ours64 - gold64).max()),
        "min_cosine": float(cos.min()),
        "passed": bool(np.abs(ours64 - gold64).max() <= tolerance),
    }


def run_parity(
    checkpoint: str,
    images: str,
    golden: Optional[str] = None,
    out: Optional[str] = None,
    tolerance: float = 1e-3,
    cfg: Optional[ModelConfig] = None,
    device="cuda",
) -> ParityReport:
    """The full layer-2 protocol. With ``golden``: diff + pass/fail. Without:
    write our descriptors to ``out`` for comparison on the reference side."""
    files = _list_images(images)
    descriptors, report = embed_with_checkpoint(checkpoint, files, cfg=cfg, device=device)
    if golden is not None:
        with np.load(golden, allow_pickle=True) as z:
            gold = np.asarray(z["descriptors"], np.float32)
        stats = compare_descriptors(descriptors, gold, tolerance)
        report.max_abs_diff = stats["max_abs_diff"]
        report.min_cosine = stats["min_cosine"]
        report.tolerance = tolerance
        report.passed = stats["passed"]
    if out is not None:
        np.savez(out, descriptors=descriptors, files=np.asarray(files, dtype=object))
        report.descriptors_path = out
    return report
