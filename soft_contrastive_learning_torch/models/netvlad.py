"""NetVLAD aggregation layer, the counterpart of
``soft_contrastive_learning_tpu/models/netvlad.py``.

Same parameterization and normalization order: a bias-free 1x1 assignment
conv in the compute dtype, softmax over clusters, ``cluster_centers``
holding the *negated* centers (added), intra-normalization with the eps
inside the sqrt, a d-major flatten and a final L2 norm. ``vlad_aggregate``
is the plain PyTorch formula; with ``use_kernels`` the aggregation goes
through K1 (``ops/kernels/netvlad.py::vlad_aggregate_fused``): its forward
and backward kernels on a CUDA device, the plain forward and the closed-form
backward on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from soft_contrastive_learning_torch.ops.kernels.netvlad import (
    vlad_aggregate,
    vlad_aggregate_fused,
)

__all__ = ["NetVLAD", "vlad_aggregate"]


class NetVLAD(nn.Module):
    """(B, H, W, D) feature map -> (B, D*K) descriptor."""

    def __init__(self, num_clusters: int = 64, dim: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, use_kernels: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        self.assignment = nn.Conv2d(dim, num_clusters, 1, bias=False, dtype=param_dtype)
        self.cluster_centers = nn.Parameter(
            torch.randn(dim, num_clusters, dtype=param_dtype) / math.sqrt(dim))

    def forward(self, feature_map: torch.Tensor) -> torch.Tensor:
        b, h, w, d = feature_map.shape
        x = feature_map.reshape(b, h * w, d)
        # the 1x1 conv over NHWC is one (B*N, D) x (D, K) product
        weight = self.assignment.weight.to(self.compute_dtype).reshape(-1, d)
        logits = x.to(self.compute_dtype) @ weight.T  # (B, N, K)
        if self.use_kernels:
            return vlad_aggregate_fused(x, logits, self.cluster_centers)
        return vlad_aggregate(x, logits, self.cluster_centers)
