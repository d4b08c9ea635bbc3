"""Batched descriptor extraction, the counterpart of
``soft_contrastive_learning_tpu/evaluation/inference.py::DescriptorExtractor``
(``extract_images``; file lists and ``run_inference`` come with the eval
slice)."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import ModelConfig, resolve_device
from soft_contrastive_learning_torch.data.pipeline import pad_to_multiple
from soft_contrastive_learning_torch.models.model import EmbeddingNet
from soft_contrastive_learning_torch.train.step import build_embed_step
from soft_contrastive_learning_torch.utils.cv import normalize_geometry


class DescriptorExtractor:
    """EmbeddingNet on ``device`` with ``params`` (a state_dict, see
    ``models/weights.py``), fed fixed-size uint8 batches."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Mapping[str, torch.Tensor],
        batch_size: int = 32,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        model = EmbeddingNet(cfg)
        model.load_state_dict(params)
        self._embed = build_embed_step(model.to(self.device))

    def extract_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        prepared = [
            normalize_geometry(
                np.asarray(im), self.cfg.image_height, self.cfg.image_width,
                keep_aspect=self.cfg.vlad_cores > 0,
            )
            for im in images
        ]
        # uint8 on the wire; the model casts
        arr = np.stack(prepared).astype(np.uint8)
        n = len(arr)
        arr = pad_to_multiple(arr, self.batch_size)
        feats = []
        for start in range(0, len(arr), self.batch_size):
            x = torch.from_numpy(arr[start : start + self.batch_size]).to(self.device)
            _, full = self._embed(x)  # raw descriptor: the one output with no reduction
            feats.append(full.cpu().numpy())
        return np.concatenate(feats)[:n]
