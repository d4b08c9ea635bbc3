"""Embedding network, the counterpart of
``soft_contrastive_learning_tpu/models/model.py::EmbeddingNet``, for the
configuration this slice serves: VGG16 + NetVLAD with ``reduction='none'``
(``ModelConfig`` refuses the others).

Returns ``(output, full_out)`` like the JAX module: ``full_out`` is the raw
descriptor and, with no reduction head, ``output`` is the same tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from soft_contrastive_learning_torch.core.config import ModelConfig, torch_dtype
from soft_contrastive_learning_torch.models.netvlad import NetVLAD
from soft_contrastive_learning_torch.models.vgg16 import VGG16


class EmbeddingNet(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        compute_dtype = torch_dtype(config.compute_dtype)
        param_dtype = torch_dtype(config.param_dtype)
        self.vgg16 = VGG16(compute_dtype=compute_dtype, param_dtype=param_dtype)
        self.netvlad = NetVLAD(
            num_clusters=config.vlad_cores, dim=512, compute_dtype=compute_dtype,
            param_dtype=param_dtype, use_kernels=config.use_kernels)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feature_map, _ = self.vgg16(images)
        full_out = self.netvlad(feature_map)
        return full_out, full_out
