#!/usr/bin/env python3
"""Time K1 (NetVLAD aggregation, forward and forward + backward) and K3 (the
fused wms loss) of one tree of the PyTorch port on one CUDA card.

    python3 scripts/torch_k1_k3_compare.py [--root DIR] [--label NAME]

``--root`` is a directory holding a ``soft_contrastive_learning_torch``
package (default: this checkout), for instance an unpacked ``git archive``
of another commit; its kernels build into that tree. Run two trees in turns
in one process list (A, B, B, A) on the same card to compare them. It uses
only what every tree of the port since K1's ``VladAggregateFn`` and K3's
``WmsLossFn`` has, on seeded inputs at the flagship's shapes:

* K1 forward at B=64 and B=50 (N=165, D=512, K=64, bf16 logits): ms a call
  back to back (CUDA events), and the same calls' host time (no sync) and
  device time (queued behind a ``torch.cuda._sleep``);
* K1 forward + backward through ``VladAggregateFn`` at B=50 against plain
  autograd of ``vlad_aggregate``, in turns;
* K3 at B=50, D=32,768: the same three times, the plain ``wms_loss``, and
  forward + backward through ``WmsLossFn`` against plain autograd.

Prints the card's name and power limit, then one JSON line. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_and_device_ms(torch, fn, reps, hold_cycles=100_000_000):
    """Host: perf_counter over the calls, no sync. Device: the calls queued
    behind a ~50 ms sleep kernel, timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import soft_contrastive_learning_torch as port
    from soft_contrastive_learning_torch.losses.ms import wms_loss
    from soft_contrastive_learning_torch.ops.kernels import _build
    from soft_contrastive_learning_torch.ops.kernels.netvlad import (
        VladAggregateFn, netvlad_aggregate_cuda, vlad_aggregate)
    from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda, wms_loss_fused

    if not Path(port.__file__).resolve().is_relative_to(root):
        print(f"imported the port from {port.__file__}, not from {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    build_s = _build.build()
    out = dict(label=args.label or str(root), build_s=build_s)

    n, d, k = 165, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in (64, 50):
        x = torch.randn((b, n, d), generator=gen, device="cuda")
        x = x / x.norm(dim=-1, keepdim=True)
        logits = (3.0 * torch.randn((b, n, k), generator=gen, device="cuda")).bfloat16()
        centers = torch.randn((d, k), generator=gen, device="cuda") / d ** 0.5
        with torch.no_grad():
            fwd = lambda: netvlad_aggregate_cuda(x, logits, centers)  # noqa: E731
            host, device = host_and_device_ms(torch, fwd, 50)
            out[f"K1_fwd_B{b}"] = dict(ms=time_ms(torch, fwd, 50), host_ms=host, device_ms=device)
    g = torch.randn((b, d * k), generator=gen, device="cuda")

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, logits, centers)]
        return torch.autograd.grad(fn(*ins), ins, g)

    turns = {"fn": [], "plain": []}
    for name in ("fn", "plain", "plain", "fn"):
        fn = VladAggregateFn.apply if name == "fn" else vlad_aggregate
        turns[name].append(time_ms(torch, lambda: grads(fn), 20))
    out["K1_fwd_bwd_B50"] = {name: statistics.mean(t) for name, t in turns.items()}

    b, dim = 50, 32768
    rng = np.random.default_rng(b)
    place = rng.uniform(0.0, 60.0, (b, 1))
    emb = np.cos(place * rng.standard_normal((1, dim)) / 10.0 + rng.uniform(0, 2 * np.pi, (1, dim)))
    emb += 0.3 * rng.standard_normal((b, dim))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    geo = torch.from_numpy(np.abs(place - place.T).astype(np.float32)).cuda()
    emb = torch.from_numpy(emb.astype(np.float32)).cuda()
    call = lambda: wms_loss_cuda(geo, emb, 0.8, 15.0)  # noqa: E731
    host, device = host_and_device_ms(torch, call, 200)
    out["K3_B50"] = dict(ms=time_ms(torch, call, 200), host_ms=host, device_ms=device,
                         plain_ms=time_ms(torch, lambda: wms_loss(geo, emb, 0.8, 15.0), 200))

    def wms_grads(fn):
        e = emb.clone().requires_grad_()
        return torch.autograd.grad(fn(geo, e, 0.8, 15.0), e)

    turns = {"fn": [], "plain": []}
    for name in ("fn", "plain", "plain", "fn"):
        fn = wms_loss_fused if name == "fn" else wms_loss
        turns[name].append(time_ms(torch, lambda: wms_grads(fn), 50))
    out["K3_fwd_bwd_B50"] = {name: statistics.mean(t) for name, t in turns.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
