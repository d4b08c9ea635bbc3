"""What the probe scripts share: timing by CUDA events, the card's bounds,
its name and power limit, and the row they print per configuration."""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from soft_contrastive_learning_torch.core.config import resolve_device

# H100 SXM, dense rates at the full power limit (NVIDIA's data sheet)
FP32_FLOPS = 67e12  # outside the tensor cores
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

# What the TPU probes varied and a CUDA kernel has no counterpart for; each
# script prints the lines that apply to it, so that no row vanishes silently.
NOT_CARRIED = {
    "fori_loop": "in-kernel fori_loop / outer lax.scan repeats: n/a (they amortized the TPU "
                 "relay's per-call floor; here a repetition is a launch, timed by CUDA events "
                 "over back-to-back launches after a warm-up)",
    "semantics": "dimension_semantics parallel / arbitrary / core / subcore: n/a (CUDA blocks "
                 "are always parallel; the tile sweep takes its place)",
    "vmem_limit": "vmem_limit_bytes: n/a (became the dynamic shared-memory attribute, set per "
                  "instantiation up to 227 KB; the larger-block sweep is this tile sweep)",
    "acc_bf16": "bf16 accumulator: n/a (the tensor cores add bf16 products in fp32)",
    "pl_dot": "pl.dot against jnp.dot: n/a (one lowering per type here: wgmma fed by TMA for "
              "bf16, mma.sync through nvcuda::wmma for int8)",
}


def time_ms(fn: Callable[[], object], reps: int) -> float:
    """Milliseconds per call on the current CUDA device: one warm-up call,
    then ``reps`` back-to-back calls between two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_and_device_ms(fn: Callable[[], object], reps: int,
                       hold_cycles: int = 100_000_000) -> Tuple[float, float]:
    """(host ms, device ms) per call on the current CUDA device. Host: the
    ``perf_counter`` time of ``reps`` back-to-back calls with no
    synchronization (what the caller's thread spends enqueueing one).
    Device: the same calls queued behind a ``torch.cuda._sleep`` of
    ``hold_cycles`` (~50 ms) that holds the stream while the host enqueues
    them, so that the CUDA events around them time the card's work alone;
    it is only that if the host finished inside the hold, which the host
    time says."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, peak: float = FP32_FLOPS) -> Tuple[float, str]:
    """The least time the card could take, in ms, and which of the two
    bounds it: ``ops`` at ``peak`` per second, or ``nbytes`` at the memory
    rate."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def gemm_bound_ms(z: int, m: int, k: int, n: int, in_dtype: torch.dtype,
                  out_dtype: torch.dtype) -> Tuple[float, str]:
    """``bound_ms`` of ``z`` products (m, k) @ (k, n): each operand read
    once, the result written once."""
    peak = INT8_OPS if in_dtype == torch.int8 else BF16_FLOPS
    nbytes = z * ((m * k + k * n) * in_dtype.itemsize + m * n * out_dtype.itemsize)
    return bound_ms(2.0 * z * m * k * n, nbytes, peak)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def parse_args(description: str, argv: Optional[Sequence[str]], default_reps: int,
               extra: Optional[Callable[[argparse.ArgumentParser], None]] = None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    parser.add_argument("--reps", type=int, default=default_reps,
                        help="timed launches per configuration, after one warm-up")
    parser.add_argument("--seed", type=int, default=0)
    if extra is not None:
        extra(parser)
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def print_header(args) -> None:
    """The card's name and power limit first (on a CUDA device), or the
    notice that a CPU run prints no rate."""
    if args.device.type == "cuda":
        print(card_line(), flush=True)
    else:
        print("device cpu: the plain versions at a small size; no time or rate is printed",
              flush=True)


def operands(shape_a, shape_b, dtype: torch.dtype, device: torch.device, seed: int):
    """Seeded operands: standard normals rounded to bf16, or integers in
    [-127, 127) as int8 (the TPU probes' inputs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        return tuple(torch.randint(-127, 127, s, generator=gen, device=device, dtype=torch.int8)
                     for s in (shape_a, shape_b))
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in (shape_a, shape_b))


def rate_row(label: str, ms: float, ops: float, control_ms: Optional[float],
             bound: Tuple[float, str], unit: str = "TFLOP/s") -> dict:
    """Print and return one configuration's row: ms, rate, the control's ms
    in the same run, and the share of the bound."""
    row = dict(label=label, ms=ms, rate=ops / ms / 1e9, unit=unit, control_ms=control_ms,
               bound_ms=bound[0], bound_by=bound[1], share_of_bound=bound[0] / ms)
    control = "n/a" if control_ms is None else f"{control_ms:9.4f} ms"
    print(f"{label:52s}: {ms:9.4f} ms {row['rate']:7.1f} {unit} | control {control} | bound "
          f"{bound[0]:.4f} ms ({bound[1]}), share {100 * row['share_of_bound']:.1f}%", flush=True)
    return row


def control_gemm_ms(a: torch.Tensor, b: torch.Tensor, reps: int) -> Optional[float]:
    """The library's time for the same product, the yardstick beside the
    hand-written kernel: ``torch.matmul`` for bf16 (bf16 result),
    ``torch._int_mm`` for a single int8 product (int32 result; it has no
    batched form). Only timed; nothing takes its result."""
    if a.dtype == torch.int8:
        return time_ms(lambda: torch._int_mm(a, b), reps) if a.ndim == 2 else None
    return time_ms(lambda: torch.matmul(a, b), reps)


def gemm_row(args, label: str, a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
             config: Optional[int] = None, control_ms: Optional[float] = None,
             unrolled: bool = False) -> dict:
    """One configuration of the product probe: on the card, time
    ``probe_gemm`` (``unrolled``: one launch per batch entry) and print its
    row; on the CPU, run the plain version once and check its shape."""
    from soft_contrastive_learning_torch.ops.kernels.probe_gemm import CONFIGS, ROUTES, probe_gemm

    z = a.shape[0] if a.ndim == 3 else 1
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if unrolled:
        def fn():  # one launch per batch entry; no copy is timed
            return [probe_gemm(a[i], b[i], out_dtype, config) for i in range(z)]
    else:
        def fn():
            return probe_gemm(a, b, out_dtype, config)

    if config is not None:
        label = f"{label} {ROUTES[a.dtype]} tile{CONFIGS[a.dtype][config]}"
    if args.device.type != "cuda":
        out = torch.stack(fn()) if unrolled else fn()
        if out.shape != (*a.shape[:-1], n) or out.dtype != out_dtype:
            raise RuntimeError(f"{label}: result {tuple(out.shape)} {out.dtype}")
        print(f"{label:52s}: ok, {tuple(out.shape)} {out.dtype}", flush=True)
        return dict(label=label, ms=None)
    ms = time_ms(fn, args.reps)
    unit = "TOP/s" if a.dtype == torch.int8 else "TFLOP/s"
    return rate_row(label, ms, 2.0 * z * m * k * n, control_ms,
                    gemm_bound_ms(z, m, k, n, a.dtype, out_dtype), unit)
