"""Embedding network, the counterpart of
``soft_contrastive_learning_tpu/models/model.py::EmbeddingNet``: VGG16, then

* ``reduction='spp'``: spatial-pyramid pooling of the fp32 conv5_3 map
  (no NetVLAD, whatever ``vlad_cores`` says), and ``full_out`` is the
  pooled output;
* else with ``vlad_cores > 0`` NetVLAD (K1 on a CUDA device);
* else the conv5_3 map flattened in NHWC order;

then the ``1fc``/``2fc``/``3fc`` head (``models/heads.py::FCHead``). With
``none`` and ``pca`` the output is ``full_out``: the PCA projection is
applied outside the module, by the train step, from the streaming PCA's
state.

``forward(images, train=False, generator=None, shard=None)`` returns
``(output, full_out)`` like the JAX module's ``apply``; ``train`` turns the
dense head's dropout on, its masks drawn from ``generator`` (the train
step's). ``shard=(rank, ranks)``: ``images`` are that rank's equal share of
a global batch, whose masks the dropout draws (``models/heads.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from soft_contrastive_learning_torch.core.config import ModelConfig, torch_dtype
from soft_contrastive_learning_torch.models.heads import FCHead, spatial_pyramid_pool
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
        self.vgg16 = VGG16(compute_dtype=compute_dtype, param_dtype=param_dtype,
                           winograd=config.winograd, remat=config.remat)
        self.netvlad = None
        if config.reduction != "spp" and config.vlad_cores > 0:
            self.netvlad = NetVLAD(
                num_clusters=config.vlad_cores, dim=512, compute_dtype=compute_dtype,
                param_dtype=param_dtype, use_kernels=config.use_kernels)
        self.fc_head = None
        if config.reduction in ("1fc", "2fc", "3fc"):
            self.fc_head = FCHead(int(config.reduction[0]), config.descriptor_dim,
                                  out_dim=config.out_dim, param_dtype=param_dtype)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        feature_map, _ = self.vgg16(images)  # NHWC, fp32
        if cfg.reduction == "spp":
            full_out = spatial_pyramid_pool(feature_map, cfg.spp_levels)
        elif self.netvlad is not None:
            full_out = self.netvlad(feature_map)
        else:
            full_out = feature_map.reshape(feature_map.shape[0], -1)
        if self.fc_head is not None:
            return self.fc_head(full_out, train=train, generator=generator, shard=shard), full_out
        return full_out, full_out  # 'none', 'spp'; 'pca' is projected by the step


def init_params(config: ModelConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A fresh state_dict drawn like flax's initializers, from ``seed``
    through a ``torch.Generator`` (the numbers differ from JAX's; the
    distributions are the same): conv and dense kernels ``lecun_normal`` (a
    normal truncated at 2 sigma, scaled to std 1/sqrt(fan_in)), biases and
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
