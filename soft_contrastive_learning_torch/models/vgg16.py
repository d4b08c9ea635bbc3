"""VGG16 convolutional backbone, the counterpart of
``soft_contrastive_learning_tpu/models/vgg16.py``.

* NHWC input in [0, 255], cast to the compute dtype before ``average_rgb``
  is subtracted; 1-channel input is promoted to RGB;
* 13 3x3 'same' convs in 5 blocks, ReLU after every conv but the last of a
  block; blocks 1-4 end with a flooring 2x2 max-pool and then a ReLU;
* conv5_3 gets no pool and no ReLU and is channel-L2-normalized in fp32
  with ``tf.nn.l2_normalize`` semantics (eps inside ``max``).

The convs run through cuDNN in ``channels_last``, parameters are kept in
``param_dtype`` and cast to the compute dtype per call, as flax does. With
``winograd=True`` the convs whose input channel count is a multiple of 128
go through ``WinogradConvFn`` (K4 on a CUDA device) with the block spec's
ReLU fused; the parameters are the same ``Conv2d`` ones either way. With
``remat=True`` each conv block (its convs, on either path) runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
activations are recomputed in the backward instead of kept, as the JAX
block's ``nn.remat``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from soft_contrastive_learning_torch.ops.kernels.winograd import WinogradConvFn

# (name, out_channels, relu_after) per conv; pool after each block's last conv.
VGG_BLOCKS = (
    (("conv1_1", 64, True), ("conv1_2", 64, False)),
    (("conv2_1", 128, True), ("conv2_2", 128, False)),
    (("conv3_1", 256, True), ("conv3_2", 256, True), ("conv3_3", 256, False)),
    (("conv4_1", 512, True), ("conv4_2", 512, True), ("conv4_3", 512, False)),
    (("conv5_1", 512, True), ("conv5_2", 512, True), ("conv5_3", 512, False)),
)


def l2_normalize(x: torch.Tensor, dim: int = -1, epsilon: float = 1e-12) -> torch.Tensor:
    """x / sqrt(max(sum(x^2), eps))."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=epsilon))


class VGG16(nn.Module):
    """Returns ``(features, grad_in)``, both NHWC: the channel-normalized
    fp32 conv5_3 map and its pre-normalization activation."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, winograd: bool = False,
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.winograd = winograd
        self.remat = remat
        self.average_rgb = nn.Parameter(torch.zeros(3, dtype=param_dtype))
        cin = 3
        for bi, specs in enumerate(VGG_BLOCKS):
            block = nn.ModuleDict()
            for name, cout, _ in specs:
                block[name] = nn.Conv2d(cin, cout, 3, padding=1, dtype=param_dtype)
                cin = cout
            self.add_module(f"block{bi + 1}", block)

    def _block(self, bi: int, x: torch.Tensor) -> torch.Tensor:
        """Block ``bi``'s convs (no pool): channels-last NCHW in and out."""
        dt = self.compute_dtype
        block = getattr(self, f"block{bi + 1}")
        for name, _, relu in VGG_BLOCKS[bi]:
            conv = block[name]
            if self.winograd and conv.in_channels % 128 == 0:
                # K4 takes and returns NHWC memory: both permutes are views
                x = WinogradConvFn.apply(x.permute(0, 2, 3, 1), conv.weight, conv.bias,
                                         relu).permute(0, 3, 1, 2)
                continue
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            if relu:
                x = F.relu(x)
        return x

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if images.ndim != 4:
            raise ValueError(f"expected NHWC input, got shape {tuple(images.shape)}")
        dt = self.compute_dtype
        x = images.to(dt)
        if x.shape[-1] == 1:
            x = x.expand(-1, -1, -1, 3)
        if x.shape[-1] != 3:
            raise ValueError(f"expected 1 or 3 channels, got {x.shape[-1]}")
        x = x - self.average_rgb.to(dt)
        # NHWC memory is NCHW in channels_last: a view, no copy
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for bi in range(len(VGG_BLOCKS)):
            if self.remat:
                x = checkpoint(self._block, bi, x, use_reentrant=False)
            else:
                x = self._block(bi, x)
            if bi < len(VGG_BLOCKS) - 1:
                x = F.relu(F.max_pool2d(x, kernel_size=2, stride=2))
        grad_in = x.permute(0, 2, 3, 1)
        features = l2_normalize(grad_in.float(), dim=-1)
        return features, grad_in
