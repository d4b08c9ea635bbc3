#!/usr/bin/env python3
"""Where the time of the PyTorch port's training goes, on one CUDA card.

    python3 scripts/torch_train_profile.py [--winograd]   (from the repository root)

The flagship as ``chip_smoke.py`` trains it: VGG16 + NetVLAD-64 at 180x240
(bf16 convs) from the committed trained weights, 2 tuples of 1+12+12
(B=50), Adam at 5e-6, fused wms (K3), mining every 20 steps over a cache of
100, on the 120-pose toy city. After one warm-up epoch it profiles (a) one
more epoch through ``Trainer.train_one_epoch`` (sampling, 6 mining
refreshes, 60 steps), (b) 10 train steps on one fixed batch, and (c) 20
calls of K3 at B=50, D=32,768, and prints for each the wall time, the
card's busy share, and the operations that took the most device time. For
(a) it also splits the host's wall time: the sampler, the mining refreshes,
and the train-step calls (the host enqueueing each step's work). The eval
hooks fire once in the warm-up epoch, before its first step, over 4 queries
and 12 reference poses (they render the held-out city on the host); the
profiled epoch is training alone. ``--winograd`` profiles the Winograd configuration
(``ModelConfig(winograd=True)``: K4 forward and ``WinogradConvFn``'s backward
on 10 of the 13 convs) and says whether the profile recorded K4's launches:
read ``winograd_kernel``'s time from the tables only if it did. Imports no
JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--winograd", action="store_true",
                        help="profile ModelConfig(winograd=True)")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from soft_contrastive_learning_torch.core.config import LossConfig, ModelConfig, TrainConfig
    from soft_contrastive_learning_torch.data.pipeline import ToyCitySource
    from soft_contrastive_learning_torch.models.weights import load_trained_params
    from soft_contrastive_learning_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    cfg = TrainConfig(model=ModelConfig(winograd=args.winograd),
                      loss=LossConfig(fused_wms=True), mining_step=20, mining_cache_size=100,
                      max_epoch=1, eval_step=1000, num_eval_queries=4, eval_ref_r=10)
    source = ToyCitySource(num_points=120, radius=150.0, img_h=180, img_w=240)

    def report(label, prof, wall_ms, rows=15):
        events = prof.key_averages()
        # device rows only (kernels, copies, sets): the ATen rows above them
        # carry the same time again
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
        print(f"{label}: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
              f"({100 * device_ms / wall_ms:.1f}%)")
        print(events.table(sort_by="self_cuda_time_total", row_limit=rows,
                           max_name_column_width=60))
        if args.winograd:
            k4 = [e for e in events if "winograd_kernel" in e.key]
            print(f"{label}: winograd_kernel rows: {sum(e.count for e in k4)} launches, "
                  f"{sum(e.self_device_time_total for e in k4) / 1e3:.2f} ms (0 means the "
                  "profiler did not record them and their time is in no row)")

    with tempfile.TemporaryDirectory() as out_dir:
        tr = Trainer(cfg, source, out_dir=out_dir, device="cuda",
                     params=load_trained_params(cfg=cfg.model))
        step, first = tr.train_step_pooled, {}

        def keep_first(state, batch, pool):
            if not first:
                first.update(batch)
            return step(state, batch, pool)

        tr.train_step_pooled = keep_first
        host = {"sample": 0.0, "refresh": 0.0, "step": 0.0}

        def timed(key, fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    host[key] += time.perf_counter() - t
            return call

        sampler_for = tr._sampler_for

        def timed_sampler(*args, **kwargs):
            sampler = sampler_for(*args, **kwargs)
            sampler.sample = timed("sample", sampler.sample)
            return sampler

        t0 = time.perf_counter()
        tr.train()  # warm-up: pool build, cuDNN algorithm choice, kernel build
        torch.cuda.synchronize()
        print(f"warm-up epoch (pool build included): {time.perf_counter() - t0:.2f} s")

        tr._run_eval = lambda *a: None  # the hooks ran in the warm-up epoch
        tr._sampler_for = timed_sampler
        tr.mining.refresh = timed("refresh", tr.mining.refresh)
        tr.train_step_pooled = timed("step", keep_first)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_one_epoch(0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report("profiled epoch (60 steps, 6 refreshes)", prof, wall_ms)
        rest = wall_ms - 1e3 * sum(host.values())
        print("host wall of the profiled epoch: " + ", ".join(
            f"{k} {1e3 * v:.1f} ms" for k, v in host.items()) + f", rest {rest:.1f} ms")

        pool = tr._image_pool.array
        for _ in range(3):
            step(tr.state, dict(first), pool)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                step(tr.state, dict(first), pool)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report("10 steps on one batch", prof, wall_ms, rows=25)
        tr.close()

    from soft_contrastive_learning_torch.ops.kernels.wms import wms_loss_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn((50, 32768), generator=gen, device="cuda")
    geo = 60.0 * torch.rand((50, 50), generator=gen, device="cuda")
    for _ in range(3):
        wms_loss_cuda(geo, emb, 0.8, 15.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            wms_loss_cuda(geo, emb, 0.8, 15.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report("20 calls of K3 at B=50, D=32,768", prof, wall_ms, rows=6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
