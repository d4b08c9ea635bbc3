"""The fused Winograd kernel stage by stage: loads only (``dma``), + the
bf16 input transform (``transform``), + the 16 position products
(``matmul``), the whole kernel (``full``). The differences between
consecutive stages' times say where the full kernel's time goes.

Counterpart of ``perf/winograd_ablate.py`` (``make_kernel(stage)`` and
``run``), at its shape by default: conv2_2 of the flagship at B = 256,
90x120, 128 -> 128 channels. ``--layer`` takes any Winograd layer of the
flagship at 180x240 and ``--batch`` its batch. Every stage is the same
kernel template (``ops/kernels/csrc/winograd.cu``) and goes through the same
wrapper, whose weight-transform launch is timed apart and taken off each
stage's time before the steps are formed. The control beside the full stage
is cuDNN's bf16 convolution.

    python -m soft_contrastive_learning_torch.perf.winograd_ablate [--device cuda] [--layer conv4_2 --batch 64]
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from soft_contrastive_learning_torch.ops.kernels.winograd import (
    weight_transform_cuda,
    winograd_stage,
)
from soft_contrastive_learning_torch.ops.winograd import STAGES
from soft_contrastive_learning_torch.perf import common

# the flagship's Winograd layer shapes at 180x240: (H, W, C, F)
FLAGSHIP_LAYERS = {
    "conv2_2": (90, 120, 128, 128),
    "conv3_1": (45, 60, 128, 256),
    "conv3_2": (45, 60, 256, 256),
    "conv4_1": (22, 30, 256, 512),
    "conv4_2": (22, 30, 512, 512),
    "conv5_1": (11, 15, 512, 512),
}
SMALL = (2, 9, 10, 64, 64)  # (B, H, W, C, F) on the CPU


def inputs(b: int, h: int, w: int, c: int, f: int, device: torch.device, seed: int):
    """Seeded NHWC bf16 activations, an OIHW fp32 weight at lecun scale and
    an fp32 bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device=device).bfloat16()
    weight = torch.randn((f, c, 3, 3), generator=gen, device=device) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn((f,), generator=gen, device=device)
    return x, weight, bias


def conv_bound_ms(b: int, h: int, w: int, c: int, f: int):
    """The full kernel's bound: 16 products per 2x2 tile on the bf16 tensor
    cores against x and U read once and the output written once."""
    tiles = b * -(-h // 2) * -(-w // 2)
    return common.bound_ms(2.0 * 16 * tiles * c * f,
                           2 * (b * h * w * c + b * h * w * f) + 2 * 16 * c * f,
                           common.BF16_FLOPS)


def run(args, b: int, h: int, w: int, c: int, f: int) -> List[dict]:
    """The four stages at one shape: a row each (on the CPU: the plain
    versions once, shapes only)."""
    x, weight, bias = inputs(b, h, w, c, f, args.device, args.seed)
    tiles = b * -(-h // 2) * -(-w // 2)
    if args.device.type != "cuda":
        for stage in STAGES:
            out = winograd_stage(stage, x, weight, bias, relu=True)
            print(f"{stage:10s}: ok, {tuple(out.shape)} {out.dtype}", flush=True)
        return []
    transform_ms = common.time_ms(lambda: weight_transform_cuda(weight), args.reps)
    x_nchw, w16, b16 = x.permute(0, 3, 1, 2), weight.bfloat16(), bias.bfloat16()
    control_ms = common.time_ms(lambda: F.relu(F.conv2d(x_nchw, w16, b16, padding=1)), args.reps)
    bound, bound_by = conv_bound_ms(b, h, w, c, f)
    print(f"weight transform (the wrapper's first launch, in every call): {transform_ms:.4f} ms; "
          f"cuDNN bf16 conv + ReLU {control_ms:.4f} ms; bound of the full kernel {bound:.4f} ms "
          f"({bound_by})")
    rows, previous = [], 0.0
    for stage in STAGES:
        ms = common.time_ms(lambda: winograd_stage(stage, x, weight, bias, relu=True), args.reps)
        kernel_ms = ms - transform_ms
        rows.append(dict(stage=stage, ms=ms, kernel_ms=kernel_ms, step_ms=kernel_ms - previous,
                         transform_ms=transform_ms, control_ms=control_ms, bound_ms=bound,
                         bound_by=bound_by))
        rate = 2.0 * 16 * tiles * c * f / ms / 1e9
        print(f"{stage:10s}: {ms:9.4f} ms a call, {kernel_ms:9.4f} without the weight transform "
              f"(+{kernel_ms - previous:8.4f} over the stage before; {rate:6.1f} TFLOP/s if the "
              f"call were the whole conv; share of bound {100 * bound / ms:.1f}%)", flush=True)
        previous = kernel_ms
    return rows


def _flags(parser) -> None:
    parser.add_argument("--layer", default="conv2_2", choices=sorted(FLAGSHIP_LAYERS))
    parser.add_argument("--batch", type=int, default=256)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = common.parse_args(__doc__, argv, default_reps=20, extra=_flags)
    common.print_header(args)
    if args.device.type == "cuda":
        b, (h, w, c, f) = args.batch, FLAGSHIP_LAYERS[args.layer]
    else:
        b, h, w, c, f = SMALL
    print(f"B={b} {h}x{w} {c}->{f}")
    run(args, b, h, w, c, f)
    print(common.NOT_CARRIED["fori_loop"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
