"""Resident and blocked products: single bf16 products small enough that
the TPU kernel held both operands in fast memory (one launch of a small grid
here), and the (4096, 2048) @ (2048, 4096) product over a grid of output
tiles at each tile shape, each beside ``torch.matmul`` on the same operands.

Counterpart of ``perf/mxu_probe.py`` (``resident_dot``, shapes and variants
of its ``main``; ``blocked_grid``, whose block and grid-semantics sweep
becomes the tile sweep).

    python -m soft_contrastive_learning_torch.perf.mxu_probe [--device cuda] [--reps N]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from soft_contrastive_learning_torch.ops.kernels.probe_gemm import CONFIGS
from soft_contrastive_learning_torch.perf import common

# (m, k, n, result type): the resident sweep, then its bf16-result variant
RESIDENT = (
    (512, 512, 512, torch.float32), (1024, 1024, 1024, torch.float32),
    (1024, 2048, 1024, torch.float32), (2048, 1024, 1024, torch.float32),
    (1024, 1024, 2048, torch.float32), (256, 4096, 1024, torch.float32),
    (1024, 2048, 1024, torch.bfloat16),
)
BLOCKED = (4096, 2048, 4096)
SMALL_RESIDENT = ((64, 64, 64, torch.float32), (48, 128, 64, torch.bfloat16))
SMALL_BLOCKED = (256, 128, 256)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = common.parse_args(__doc__, argv, default_reps=20)
    common.print_header(args)
    on_card = args.device.type == "cuda"
    for m, k, n, out_dtype in (RESIDENT if on_card else SMALL_RESIDENT):
        a, b = common.operands((m, k), (k, n), torch.bfloat16, args.device, args.seed)
        control_ms = common.control_gemm_ms(a, b, args.reps) if on_card else None
        tag = "bf16->bf16" if out_dtype == torch.bfloat16 else "bf16->fp32"
        common.gemm_row(args, f"A resident {tag} ({m},{k})@({k},{n})", a, b, out_dtype, None,
                        control_ms)
    m, k, n = BLOCKED if on_card else SMALL_BLOCKED
    a, b = common.operands((m, k), (k, n), torch.bfloat16, args.device, args.seed)
    control_ms = common.control_gemm_ms(a, b, args.reps) if on_card else None
    for config in range(len(CONFIGS[torch.bfloat16])):
        common.gemm_row(args, f"B grid bf16->fp32 ({m},{k})@({k},{n})", a, b, torch.float32,
                        config, control_ms)
    for key in ("fori_loop", "semantics", "pl_dot"):
        print(common.NOT_CARRIED[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
