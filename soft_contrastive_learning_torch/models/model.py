"""Embedding network, the counterpart of
``soft_contrastive_learning_tpu/models/model.py::EmbeddingNet``, for the
configuration this slice serves: VGG16 + NetVLAD with ``reduction='none'``
(``ModelConfig`` refuses the others).

Returns ``(output, full_out)`` like the JAX module: ``full_out`` is the raw
descriptor and, with no reduction head, ``output`` is the same tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from soft_contrastive_learning_torch.core.config import ModelConfig, torch_dtype
from soft_contrastive_learning_torch.models.netvlad import NetVLAD
from soft_contrastive_learning_torch.models.vgg16 import VGG16

# std of a unit normal truncated at +-2, as flax's variance_scaling divides by
_TRUNC_STD = 0.87962566103423978


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


def init_params(config: ModelConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A fresh state_dict drawn like flax's initializers, from ``seed``
    through a ``torch.Generator`` (the numbers differ from JAX's; the
    distributions are the same): conv kernels ``lecun_normal`` (a normal
    truncated at 2 sigma, scaled to std 1/sqrt(fan_in)), biases and
    ``average_rgb`` zero, NetVLAD centers normal(0, 1/sqrt(512))."""
    gen = torch.Generator().manual_seed(seed)
    state = EmbeddingNet(config).state_dict()
    for name, t in state.items():
        if name.endswith("weight"):
            sigma = (1.0 / math.sqrt(t[0].numel())) / _TRUNC_STD
            nn.init.trunc_normal_(t, std=sigma, a=-2 * sigma, b=2 * sigma, generator=gen)
        elif name.endswith("cluster_centers"):
            nn.init.normal_(t, std=1.0 / math.sqrt(t.shape[0]), generator=gen)
        else:
            nn.init.zeros_(t)
    return state
