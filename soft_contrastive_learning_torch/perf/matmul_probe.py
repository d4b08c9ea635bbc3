"""The Winograd kernel's products alone: 16 independent (P, C) @ (C, F)
bf16 products with fp32 sums, as one batched launch, as 16 launches, and as
one large single product, at the eight shapes of ``perf/matmul_probe.py``,
each beside ``torch.matmul`` on the same operands.

Counterpart of ``perf/matmul_probe.py::probe`` (modes ``batched``,
``unrolled``, ``single``). P = 240 and 360 end in a ragged tile of rows,
which the kernel masks.

    python -m soft_contrastive_learning_torch.perf.matmul_probe [--device cuda] [--reps N]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from soft_contrastive_learning_torch.perf import common

# (mode, batch, P, C, F)
SHAPES = (
    ("batched", 16, 240, 128, 128),
    ("batched", 16, 1024, 128, 128),
    ("unrolled", 16, 1024, 128, 128),
    ("batched", 16, 360, 256, 256),
    ("batched", 16, 1024, 512, 512),
    ("single", 1, 4096, 512, 512),
    ("single", 1, 16384, 128, 128),
    ("single", 1, 4096, 128, 512),
)
SMALL = (("batched", 16, 40, 64, 64), ("unrolled", 16, 48, 64, 64), ("single", 1, 72, 64, 128))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = common.parse_args(__doc__, argv, default_reps=50)
    common.print_header(args)
    for mode, z, m, k, n in (SHAPES if args.device.type == "cuda" else SMALL):
        shape_a, shape_b = ((m, k), (k, n)) if mode == "single" else ((z, m, k), (z, k, n))
        a, b = common.operands(shape_a, shape_b, torch.bfloat16, args.device, args.seed)
        control_ms = (common.control_gemm_ms(a, b, args.reps)
                      if args.device.type == "cuda" else None)
        common.gemm_row(args, f"{mode}{z if z > 1 else ''} ({m},{k})@({k},{n})", a, b,
                        torch.float32, None, control_ms, unrolled=mode == "unrolled")
    for key in ("fori_loop",):
        print(common.NOT_CARRIED[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
