"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
(dense, at its 700 W limit) and the operations and bytes of each kernel and
of the model, from shapes. Frozen copies of the port's formulas, so that
the yardstick does not move when the program does."""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_FP32 = 67e12  # FLOP/s, outside the tensor cores
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12  # OP/s
PEAK_HBM = 3.35e12  # bytes/s

# VGG16's 13 3x3 convs as (in, out) channels per block; a floor 2x2 pool after blocks 1-4
VGG_BLOCKS: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((3, 64), (64, 64)),
    ((64, 128), (128, 128)),
    ((128, 256), (256, 256), (256, 256)),
    ((256, 512), (512, 512), (512, 512)),
    ((512, 512), (512, 512), (512, 512)),
)


def conv_maps(h: int, w: int) -> Sequence[Tuple[int, int]]:
    """The (H, W) that each block's convs run at."""
    out = []
    for _ in VGG_BLOCKS:
        out.append((h, w))
        h, w = h // 2, w // 2
    return out


def conv_macs(h: int, w: int) -> int:
    """Multiply-adds of the 13 convs on one h x w image."""
    return sum(hh * ww * 9 * cin * cout
               for (hh, ww), block in zip(conv_maps(h, w), VGG_BLOCKS) for cin, cout in block)


def netvlad_flops(h: int, w: int, clusters: int, dim: int = 512) -> int:
    """The assignment's 1x1 conv and the aggregation, on the conv5_3 map."""
    hh, ww = conv_maps(h, w)[-1]
    return 2 * 2 * hh * ww * clusters * dim


def forward_flops(h: int, w: int, clusters: int) -> int:
    """One image's forward: the convs and NetVLAD."""
    return 2 * conv_macs(h, w) + netvlad_flops(h, w, clusters)


def int8_ops(h: int, w: int) -> int:
    """The integer operations of one image through the int8 conv stack."""
    return 2 * conv_macs(h, w)


def bound_s(flops: float, peak: float, nbytes: float) -> float:
    """The least time: the larger of operations over the peak and bytes over HBM's."""
    return max(flops / peak, nbytes / PEAK_HBM)


def k2_bound_s(q: int, r: int, d: int, k: int) -> float:
    """K2 (streaming top-k, 3xTF32): 3 x 2QRD at TF32 against the index and
    the queries read once and the (Q, k) distances and ids written."""
    return bound_s(3 * 2 * q * r * d, PEAK_TF32, 4 * (r * d + q * d) + 12 * q * k)


def k1_forward_bound_s(b: int, n: int, k: int, d: int) -> float:
    """K1's forward (NetVLAD aggregation, fp32 FMAs): 2BNKD against x (fp32),
    the bf16 logits, the centers and the (B, KD) output."""
    return bound_s(2 * b * n * k * d, PEAK_FP32, 4 * b * n * d + 2 * b * n * k + 4 * d * k
                   + 4 * b * k * d)


def k1_backward_bound_s(b: int, n: int, k: int, d: int) -> float:
    """K1's backward: twice the forward's operations, against its operands
    (x, logits, centers, the cotangent) read and dx, dlogits, dC written."""
    return bound_s(4 * b * n * k * d, PEAK_FP32,
                   2 * (4 * b * n * d + 2 * b * n * k + 4 * d * k) + 4 * b * k * d)


def k3_bound_s(b: int, d: int) -> float:
    """K3 (the wms loss's forward): B(B+1)D against the (B, D) embeddings and
    the (B, B) distances read and the loss written."""
    return bound_s(b * (b + 1) * d, PEAK_FP32, 4 * (b * d + b * b) + 4)
