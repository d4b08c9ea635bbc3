"""Descriptor reduction heads, the counterpart of
``soft_contrastive_learning_tpu/models/heads.py``: spatial-pyramid pooling,
the streaming PCA's whitening projection and the 1-3 layer dense head. All
three are plain PyTorch: they were plain XLA, not Pallas, in the JAX package.

Dropout (``FCHead``, rate 0.5 between its layers, a constant as in the
JAX head, which reads nothing of its config's ``dropout_keep_prob``) draws its masks from the
``torch.Generator`` it is handed, the train step's own (``TrainState.rng``,
on the model's device, kept in checkpoints), never from the global one, so
that a resumed run draws the masks the uninterrupted run drew. The JAX
masks come from its ``jax.random`` key, which the port does not reproduce:
the two packages agree in eval mode, and with ``1fc``, which has no dropout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from soft_contrastive_learning_torch.pca.whiten import fp32_matmuls


def spatial_pyramid_pool(feature_map: torch.Tensor, levels: int = 3) -> torch.Tensor:
    """Max spatial-pyramid pooling of an NHWC map (B, H, W, C) over 2^l x 2^l
    grids, l < ``levels``: (B, sum_l 4^l * C), level-major, then row-major
    bins, then channels. Bin edges are numpy's ``linspace(0, h, bins +
    1).round()``, halves to even (h = 11 at level 1: [0, 6, 11])."""
    _, h, w, _ = feature_map.shape
    pooled = []
    for level in range(levels):
        bins = 2**level
        h_edges = np.linspace(0, h, bins + 1).round().astype(int)
        w_edges = np.linspace(0, w, bins + 1).round().astype(int)
        for i in range(bins):
            for j in range(bins):
                region = feature_map[:, h_edges[i] : h_edges[i + 1], w_edges[j] : w_edges[j + 1]]
                pooled.append(region.amax(dim=(1, 2)))
    return torch.cat(pooled, dim=-1)


def apply_pca_projection(features: torch.Tensor, components: torch.Tensor, mean: torch.Tensor,
                         variance: torch.Tensor) -> torch.Tensor:
    """The whitening projection ``(x - m) @ V^T / sqrt(var)`` of (B, D)
    features by the streaming PCA's (out_dim, D) components, (D,) mean and
    (out_dim,) variance; the product in fp32 with TF32 off."""
    with fp32_matmuls():
        x = (features - mean) @ components.T
    return x / torch.sqrt(variance)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's: keep with probability 1 - rate, scale the
    kept values by 1 / (1 - rate), the mask drawn from ``generator``."""
    if generator is None:
        raise ValueError("dropout in training needs the step's generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class FCHead(nn.Module):
    """1-3 ``nn.Linear`` layers (``fc1``..``fc{n}``): hidden layers of
    ``hidden_dim`` with ReLU and dropout after each, then ``out_dim``; in
    fp32 whatever the backbone's compute dtype, as the JAX head."""

    def __init__(self, num_layers: int, in_dim: int, out_dim: int = 512, hidden_dim: int = 4096,
                 dropout_rate: float = 0.5, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_layers not in (1, 2, 3):
            raise ValueError(f"FCHead takes 1-3 layers, got {num_layers}")
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"fc{i + 1}", nn.Linear(dims[i], dims[i + 1], dtype=param_dtype))

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f"fc{i}")
        return F.linear(x, layer.weight.float(), layer.bias.float())

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.float()
        with fp32_matmuls():
            for i in range(1, self.num_layers):
                x = torch.relu(self._dense(i, x))
                if train:
                    x = dropout(x, self.dropout_rate, generator)
            return self._dense(self.num_layers, x)
