#!/usr/bin/env python3
"""Where the time of the PyTorch port's embed goes, on one CUDA card.

    python3 scripts/torch_embed_profile.py [--winograd]   (from the repository root)

Embeds 512 seeded 180x240 uint8 images through
``soft_contrastive_learning_torch.serving.DescriptorService`` (flagship
config, committed trained weights, batch 64) and prints: the end-to-end
seconds, the pieces of one batch timed alone (stack, copy in, model, copy
out), the card's busy share over one profiled embed, and the operations that
took the most device time. ``--winograd`` profiles the Winograd
configuration (``ModelConfig(winograd=True)``, K4 on 10 of the 13 convs) and
says whether the profile recorded K4's launches: read ``winograd_kernel``'s
time from the table only if it did. Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--winograd", action="store_true",
                        help="profile ModelConfig(winograd=True)")
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from soft_contrastive_learning_torch.core.config import ModelConfig
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.serving import DescriptorService

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    cfg = ModelConfig(winograd=args.winograd)
    service = DescriptorService(cfg, load_trained_params(cfg=cfg), batch_size=64)
    imgs = np.random.default_rng(0).integers(0, 256, (512, 180, 240, 3), dtype=np.uint8)
    service.embed(imgs)  # warm-up: cuDNN algorithm choice, kernel build
    for _ in range(2):
        t0 = time.perf_counter()
        service.embed(imgs)
        print(f"embed 512 images: {time.perf_counter() - t0:.4f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    arr, stack_ms = timed(lambda: np.stack(list(imgs[:64])).astype(np.uint8))
    x, h2d_ms = timed(lambda: torch.from_numpy(arr).cuda())
    with torch.inference_mode():
        full, model_ms = timed(lambda: service.extractor._embed(x)[1])
    _, d2h_ms = timed(lambda: full.cpu().numpy())
    print(f"one batch of 64: stack {stack_ms:.3f} ms, copy in {h2d_ms:.3f} ms, "
          f"model {model_ms:.3f} ms, copy out {d2h_ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.embed(imgs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device rows only (kernels, copies): the ATen rows above them carry the
    # same time again
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(f"profiled embed: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
          f"({100 * device_ms / wall_ms:.1f}%)")
    print(events.table(sort_by="self_cuda_time_total", row_limit=15, max_name_column_width=60))
    if args.winograd:
        rows = [e for e in events if "winograd_kernel" in e.key]
        print(f"winograd_kernel rows in the profile: {sum(e.count for e in rows)} launches, "
              f"{sum(e.self_device_time_total for e in rows) / 1e3:.2f} ms (80 launches run; "
              "0 means the profiler did not record them and their time is in no row)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
