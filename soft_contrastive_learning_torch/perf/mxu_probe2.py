"""The large blocked product: one (8192, 4096) @ (4096, 8192) bf16 problem
(550 GFLOP) through the hand-written kernel at each of its tile shapes,
beside ``torch.matmul`` on the same operands in the same run.

Counterpart of ``perf/mxu_probe2.py`` and ``perf/mxu_probe3.py``
(``pallas_matmul``: a 3-D grid with K innermost and an fp32 accumulator,
swept over block shapes; the second script only repeats the sweep with
larger blocks under a raised VMEM limit, which has no counterpart here, so
the two are one sweep).

    python -m soft_contrastive_learning_torch.perf.mxu_probe2 [--device cuda] [--reps N]
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch

from soft_contrastive_learning_torch.ops.kernels.probe_gemm import CONFIGS
from soft_contrastive_learning_torch.perf import common

M, K, N = 8192, 4096, 8192
SMALL = (320, 128, 256)  # on the CPU


def sweep(args, in_dtype: torch.dtype, out_dtype: torch.dtype, label: str) -> List[dict]:
    """The problem at every tile shape, after the library's control."""
    m, k, n = (M, K, N) if args.device.type == "cuda" else SMALL
    a, b = common.operands((m, k), (k, n), in_dtype, args.device, args.seed)
    control_ms = None
    if args.device.type == "cuda":
        control_ms = common.control_gemm_ms(a, b, args.reps)
        name = "torch._int_mm" if in_dtype == torch.int8 else "torch.matmul"
        print(f"{name + ' control':52s}: {control_ms:9.4f} ms "
              f"{2.0 * m * k * n / control_ms / 1e9:7.1f} "
              f"{'TOP/s' if in_dtype == torch.int8 else 'TFLOP/s'}", flush=True)
    return [common.gemm_row(args, f"{label} ({m},{k})@({k},{n})", a, b, out_dtype, config,
                            control_ms) for config in range(len(CONFIGS[in_dtype]))]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = common.parse_args(__doc__, argv, default_reps=5)
    common.print_header(args)
    sweep(args, torch.bfloat16, torch.bfloat16, "bf16->bf16")
    for key in ("fori_loop", "semantics", "vmem_limit", "acc_bf16"):
        print(common.NOT_CARRIED[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
