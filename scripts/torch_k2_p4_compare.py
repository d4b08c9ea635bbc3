#!/usr/bin/env python3
"""Time K2 (the streaming top-k) and the int8 probe product (P4) of one tree
of the PyTorch port on one CUDA card.

    python3 scripts/torch_k2_p4_compare.py [--root DIR] [--label NAME]

``--root`` is a directory holding a ``soft_contrastive_learning_torch``
package (default: this checkout), for instance an unpacked ``git archive``
of another commit; its kernels build into that tree. Run two trees in turns
(A, B, B, A) on the same card to compare them. It uses only what every tree
of the port since the probes' int8 kernel has (``topk_l2_cuda``,
``probe_gemm``), on seeded inputs:

* K2 at Q=64, R=66,048, D=32,768 (the serving index) with k=1, 5 and 128,
  and at Q=256 with k=5; multiples of 1/8, held to the plain version's ids;
* P4: (8192, 4096) @ (4096, 8192) int8 -> int32 at the tile the wrapper
  chooses, held to ``torch._int_mm`` bit for bit, and ``torch._int_mm``'s
  own time;
* ``/search`` as ``chip_smoke.py`` serves it: the trained flagship embeds
  512 seeded images into an index padded with seeded unit vectors to 66,048
  rows, then ``DescriptorService.search`` of 64 images (their embed and one
  K2 launch), the median of 5 on the host clock. The weights are the tree's
  own ``soft_contrastive_learning_tpu/assets/flagship_trained.npz``.

Times are CUDA events over back-to-back calls after a warm-up. Prints the
card's name and power limit, then one JSON line. Imports no JAX.
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


def eighths(torch, gen, shape):
    out = torch.empty(shape, dtype=torch.float32, device="cuda")
    for s in range(0, shape[0], 2048):
        e = min(s + 2048, shape[0])
        out[s:e] = torch.randint(-8, 9, (e - s, shape[1]), generator=gen, device="cuda") / 8.0
    return out


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
    from soft_contrastive_learning_torch.ops.kernels import _build
    from soft_contrastive_learning_torch.ops.kernels.probe_gemm import CONFIGS, probe_gemm, \
        choose_config
    from soft_contrastive_learning_torch.ops.kernels.topk import topk_l2_cuda, \
        topk_l2_stream_plain

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if Path(port.__file__).resolve().parents[1] != root:
        print(f"imported the port from {port.__file__}, not from {root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"build {_build.build(['topk', 'probe_gemm']):.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(1)
    n_refs, d = 66048, 32768
    r = eighths(torch, gen, (n_refs, d))
    q256 = eighths(torch, gen, (256, d))
    q = q256[:64].contiguous()
    out = dict(label=args.label, root=str(root))
    for nq_, qq, ks in ((64, q, (1, 5, 128)), (256, q256, (5,))):
        for k in ks:
            got = topk_l2_cuda(qq, r, k)[1]
            if not torch.equal(got, topk_l2_stream_plain(qq, r, k)[1]):
                print(f"K2 Q={nq_} k={k}: ids differ from the plain version", file=sys.stderr)
                return 1
            out[f"K2_Q{nq_}_k{k}_ms"] = time_ms(torch, lambda: topk_l2_cuda(qq, r, k), 5)
    del r, q, q256
    torch.cuda.empty_cache()

    a = torch.randint(-127, 127, (8192, 4096), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 127, (4096, 8192), generator=gen, device="cuda", dtype=torch.int8)
    config = choose_config(8192, 8192, 4096, dtype=torch.int8)
    if not torch.equal(probe_gemm(a, b), torch._int_mm(a, b)):
        print("P4 differs from torch._int_mm", file=sys.stderr)
        return 1
    out["P4_tile"] = CONFIGS[torch.int8][config]
    out["P4_ms"] = time_ms(torch, lambda: probe_gemm(a, b), 10)
    out["int_mm_ms"] = time_ms(torch, lambda: torch._int_mm(a, b), 10)
    del a, b
    torch.cuda.empty_cache()

    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.serving import DescriptorService

    cfg = ModelConfig()
    params = load_trained_params(cfg=cfg)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (576, 12, 16, 3), dtype="uint8").repeat(15, 1).repeat(15, 2)
    index = torch.empty((n_refs, cfg.descriptor_dim), dtype=torch.float32, device="cuda")
    index[:512] = torch.from_numpy(DescriptorService(cfg, params, batch_size=64)
                                   .embed(imgs[:512])).cuda()
    for s in range(512, n_refs, 4096):
        v = torch.randn((min(4096, n_refs - s), cfg.descriptor_dim), generator=gen, device="cuda")
        index[s : s + len(v)] = v / v.norm(dim=1, keepdim=True)
    service = DescriptorService(cfg, params, batch_size=64, index=index)
    queries = imgs[512:]
    service.search(queries, k=5)  # warm-up
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        service.search(queries, k=5)
        runs.append(1e3 * (time.perf_counter() - t0))
    out["search_ms"] = statistics.median(runs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
