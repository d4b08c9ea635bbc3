"""int8 beside bf16: the (8192, 4096) @ (4096, 8192) problem with int8
operands and int32 sums through the hand-written kernel at each tile shape,
beside ``torch._int_mm``, and the bf16 sweep in the same run, so that the
two rates compare on one card in one call.

Counterpart of ``perf/mxu_probe4.py`` (``pallas_matmul`` in int8 with an
int32 accumulator, the XLA int8 control, and the best bf16 configuration
rerun).

    python -m soft_contrastive_learning_torch.perf.mxu_probe4 [--device cuda] [--reps N]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from soft_contrastive_learning_torch.perf import common
from soft_contrastive_learning_torch.perf.mxu_probe2 import sweep


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = common.parse_args(__doc__, argv, default_reps=5)
    common.print_header(args)
    int8_rows = sweep(args, torch.int8, torch.int32, "int8->int32")
    bf16_rows = sweep(args, torch.bfloat16, torch.bfloat16, "bf16->bf16")
    if args.device.type == "cuda":
        best8 = min(int8_rows, key=lambda r: r["ms"])
        best16 = min(bf16_rows, key=lambda r: r["ms"])
        print(f"best int8 {best8['rate']:.1f} TOP/s ({best8['label']}) against best bf16 "
              f"{best16['rate']:.1f} TFLOP/s ({best16['label']}): "
              f"{best8['rate'] / best16['rate']:.2f}x")
    for key in ("fori_loop", "semantics", "vmem_limit"):
        print(common.NOT_CARRIED[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
