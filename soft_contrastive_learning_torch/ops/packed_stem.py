"""Packed-width rewrite of the VGG16 stem (block1 + pool), exact. Own copy
of ``soft_contrastive_learning_tpu/ops/packed_stem.py``, on NHWC tensors.

On the TPU, block1's 64-channel convs filled half of the MXU's 128 lanes;
packing two adjacent width pixels into the channels makes both the
contraction (2C a tap) and the output (2F) 128 wide. The rewrite is
algebraically exact: a SAME 3x3 stride-1 conv on (H, W, C) equals a VALID
(3, 2) conv on the shifted width-packed tensor

    X'[h, w', pin*C + c] = Xpad[h, 2*w' + pin, c],   Xpad = zero-pad W by 1+1

with the packed kernel

    K'[dh, dwp, pin*C + c, pout*F + f] = K[dh, dw+1, c, f]
        where dw = 2*dwp + pin - pout - 1, zero when |dw| > 1,

and the 2x2 max-pool becomes a max over the two channel halves and row
pairs. Parameters keep the standard (3, 3, C, F) layout (HWIO, as JAX's;
``models/vgg16.py`` passes its OIHW weights permuted), so checkpoints do
not change. The convs run through ``F.conv2d`` (cuDNN on the card), as
JAX ran them as XLA convolutions. In fp32 the packed block equals the
standard one up to the convs' summation order (``tests/test_torch_packed_stem.py``:
within 1e-5 of the largest output); on integers (``models/quant.py``'s
int8 stem) it is exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_kernel(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) -> (3, 2, 2C, 2F) packed kernel (zeros outside the 3x3)."""
    kh, kw, c, f = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_kernel takes a 3x3 kernel, got {kh}x{kw}")
    kp = k.new_zeros((3, 2, 2 * c, 2 * f))
    for pout in (0, 1):
        for dwp in (0, 1):
            for pin in (0, 1):
                dw = 2 * dwp + pin - pout - 1
                if -1 <= dw <= 1:
                    kp[:, dwp, pin * c : (pin + 1) * c, pout * f : (pout + 1) * f] = k[:, dw + 1]
    return kp


def pack_input(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H+2, W/2+1, 2C) shifted width-packing with SAME
    height padding baked in (the packed conv then runs VALID)."""
    b, h, w, c = x.shape
    if w % 2:
        raise ValueError(f"pack_input takes an even width, got {w}")
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xpad.reshape(b, h + 2, (w + 2) // 2, 2 * c)


def repack_shifted(yp: torch.Tensor) -> torch.Tensor:
    """Packed conv output (B, H, W/2, 2F) -> the next conv's shifted packed
    input (B, H+2, W/2+1, 2F): channel half 0 = previous unpacked column
    (phase-1 shifted right by one packed col), half 1 = current column."""
    f = yp.shape[-1] // 2
    prev_col = F.pad(yp[..., f:], (0, 0, 1, 0, 1, 1))
    cur_col = F.pad(yp[..., :f], (0, 0, 0, 1, 1, 1))
    return torch.cat([prev_col, cur_col], dim=-1)


def packed_conv(xp: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID (3, 2) conv of a packed input with a standard (3, 3, C, F)
    kernel -> packed (B, H, W/2, 2F) output, the bias added after."""
    kp = pack_kernel(k).permute(3, 2, 0, 1)  # HWIO -> OIHW
    yp = F.conv2d(xp.permute(0, 3, 1, 2), kp).permute(0, 2, 3, 1)
    return yp + torch.cat([b, b]).to(yp.dtype)


def packed_maxpool(yp: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool directly in packed layout:
    (B, H, W/2, 2F) -> (B, H/2, W/2, F). Width pairs are the two phase
    halves; height pairs are adjacent rows. Any dtype (fp32, and the
    requantized int8, where max commutes with the monotone quantization)."""
    f = yp.shape[-1] // 2
    m = torch.maximum(yp[..., :f], yp[..., f:])  # over width phases
    return torch.maximum(m[:, 0::2], m[:, 1::2])  # over height pairs


def packed_maxpool_relu(yp: torch.Tensor) -> torch.Tensor:
    """packed_maxpool + ReLU (the float stem's block-boundary order)."""
    return F.relu(packed_maxpool(yp))


def unpack_width(yp: torch.Tensor) -> torch.Tensor:
    """Packed conv output -> standard layout: (B, H, W/2, 2F) -> (B, H, W, F).
    ``packed_conv``'s output is Y'[h, w', pout*F + f] = Y[h, 2w'+pout, f]
    (pout-major channels), so the unpack is a plain reshape."""
    b, h, wp, f2 = yp.shape
    return yp.reshape(b, h, wp * 2, f2 // 2)


def packed_stem_block(
    x: torch.Tensor,  # (B, H, W, 3) raw input (mean already subtracted)
    k1: torch.Tensor, b1: torch.Tensor,  # conv1_1 (3, 3, 3, 64)
    k2: torch.Tensor, b2: torch.Tensor,  # conv1_2 (3, 3, 64, 64)
) -> torch.Tensor:
    """conv1_1 -> ReLU -> conv1_2 -> maxpool 2x2 -> ReLU, fully packed:
    VGG16's block1 with its trailing pool and ReLU, (B, H/2, W/2, 64)."""
    y1 = F.relu(packed_conv(pack_input(x), k1, b1))
    y2 = packed_conv(repack_shifted(y1), k2, b2)
    return packed_maxpool_relu(y2)
