#!/usr/bin/env python3
"""Time the JPEG path (the host entropy decoder, J1 and ``decode_img``) of
one tree of the PyTorch port on one CUDA card.

    python3 scripts/torch_jpeg_compare.py [--root DIR] [--label NAME] [--reps N]

``--root`` is a directory holding a ``soft_contrastive_learning_torch``
package (default: this checkout), for instance an unpacked ``git archive``
of another commit; its kernels build into that tree. Run two trees in turns
(A, B, B, A) in one chip call to compare them. The files are this
checkout's fixtures (``assets/jpeg``), whichever tree is timed. A tree with
``jpeg_pixels_batch`` (one J1 launch per batch) is timed through it; an
older one (``jpeg_pixels_cuda`` per image, two launches each) image by
image, a batch as its images one after another.

Cases: 180x240 4:2:0 alone; a batch of 64 of the seventeen original
180x240 fixtures; the 1280x960 frame, plain and smoothed (a progressive
file cut short); CMYK and YCCK at 180x240. For each:

* ``device_ms``: J1's work on the card for the case, queued behind a
  ``torch.cuda._sleep`` and timed by CUDA events (coefficients already on
  the card), and ``launch_host_ms``, the host's time to enqueue it; where
  the tree has them, one profiled launch's phase clocks (``phases``: ns a
  tile in each phase, the launch's span, the most tiles on one SM);
* ``call_host_ms``: the host's time for the call from host coefficients
  to pixels queued on the card, from an idle card (median; the old tree's
  two pageable copies and call per image, the new tree's packing, pinned
  copy and launch), and ``call_ms`` the same call waited for;
* ``bound_ms``: each coefficient (2 B) and table entry (4 B) read once,
  each RGB byte written once, at 3.35 TB/s (bytes bound it);
* ``kernels``: torch.profiler's device time a case by kernel (the old
  tree's IDCT and pixel launches apart) and the launches a case.

Then ``decode_img`` on the card in img/s on 1 and 8 threads, the host
entropy decode of the two sizes, and (new tree) ``decode_imgs`` of the 64
with the entropy decodes on 8 threads: each rate the median of ``PASSES``
passes over 256 images, with every pass's rate beside it (the card's host
shares its cores, so one pass varies by 2x or more). Prints the card's name and power
limit, then one JSON line. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1] / "soft_contrastive_learning_torch" / "assets" / "jpeg"
RATE = ("adobe_rgb.jpg", "c411.jpg", "c420_q95.jpg", "c422.jpg", "c440.jpg", "c444.jpg",
        "gray.jpg", "orient2.jpg", "orient3.jpg", "orient4.jpg", "orient5.jpg", "orient6.jpg",
        "orient7.jpg", "orient8.jpg", "progressive_cv2.jpg", "progressive_pil.jpg", "restart3.jpg")
CASES = (("180x240", ("c420_q95.jpg",)), ("batch64_180x240", tuple(RATE[i % 17] for i in range(64))),
         ("1280x960", ("frame_1280x960.jpg",)), ("smoothed_1280x960", ("frame_progressive_cut.jpg",)),
         ("cmyk_180x240", ("cmyk_pil.jpg",)), ("ycck_420_180x240", ("ycck_420.jpg",)))
HBM_BYTES_PER_S = 3.35e12
PASSES = 5  # passes of 256 images a decode rate: the median, and each pass


def host_and_device_ms(torch, fn, reps):
    """Host: perf_counter over the calls, no sync. Device: the calls queued
    behind a sleep kernel three times as long as the host takes to enqueue
    them (at least ~50 ms), timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_cycles = int(max(1e8, 3 * one * reps * 2e9))
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


def call_ms(torch, fn, reps):
    """(host ms, ms to completion) of one call from an idle card, medians."""
    fn()
    torch.cuda.synchronize()
    host, done = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        done.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(host), statistics.median(done)


def kernel_us(torch, fn, reps):
    """torch.profiler over ``reps`` calls: each CUDA kernel's device time a
    call (us) by name, and the launches a call; {} where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us and "kernel" in e.key:  # idct_kernel and pixel_kernel (the old design), j1_kernel
            out[e.key[:90]] = dict(us=us / reps, launches=e.count / reps)
    return out


def bound_ms(batch):
    nbytes = sum(2 * co.coefs.size + 4 * co.quant.size + 3 * co.frame.height * co.frame.width
                 for co in batch)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--label", default="")
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import soft_contrastive_learning_torch as port
    from soft_contrastive_learning_torch.ops.kernels import _build
    from soft_contrastive_learning_torch.ops.kernels import jpeg as kj
    from soft_contrastive_learning_torch.utils import io

    if not Path(port.__file__).resolve().is_relative_to(root):
        print(f"imported the port from {port.__file__}, not from {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    batched = hasattr(kj, "jpeg_pixels_batch")
    out = dict(label=args.label or str(root), batched=batched, build_s=_build.build(["jpeg"]))
    files = {n: (HERE / n).read_bytes() for _, names in CASES for n in names}
    cuda = torch.device("cuda")
    for label, names in CASES:
        batch = [kj.entropy_decode(files[n], n) for n in names]
        if batched:
            launch = kj.staged_launcher(batch, cuda)
            kernel = launch
            call = lambda: kj.jpeg_pixels_batch(batch, cuda)  # noqa: E731
        else:
            dev = [(torch.from_numpy(co.coefs).cuda(), torch.from_numpy(co.quant).cuda(), co.frame)
                   for co in batch]
            kernel = lambda: [kj.jpeg_pixels_cuda(*d) for d in dev]  # noqa: E731
            call = lambda: [kj.jpeg_pixels_cuda(torch.from_numpy(co.coefs).to(cuda),  # noqa: E731
                                                torch.from_numpy(co.quant).to(cuda), co.frame)
                            for co in batch]
        launches = kj.jpeg_pixels_cuda.launches
        kernel()
        per_kernel = kj.jpeg_pixels_cuda.launches - launches
        launch_host, device = host_and_device_ms(torch, kernel, args.reps)
        host, done = call_ms(torch, call, args.reps)
        out[label] = dict(images=len(batch), device_ms=device, launch_host_ms=launch_host,
                          call_host_ms=host, call_ms=done, bound_ms=bound_ms(batch),
                          counted_launches=per_kernel,
                          smoothed=sum(co.frame.smoothing is not None for co in batch))
        out[label]["kernels"] = kernel_us(torch, kernel, 10)
        if hasattr(kj, "phase_clocks"):  # one profiled launch: ns per phase a tile
            tiles = launch.plan.tiles
            clocks = torch.zeros(kj.CLOCKS * tiles, dtype=torch.int64, device=cuda)
            kj.staged_launcher(batch, cuda, clocks)()
            torch.cuda.synchronize()
            out[label]["phases"] = kj.phase_clocks(clocks, tiles)
            out[label]["tiles"] = tiles
        print(f"{label}: {len(batch)} images, device {device:.5f} ms, call host {host:.4f} ms "
              f"(to done {done:.4f}), bound {bound_ms(batch):.5f} ms", flush=True)
    for label, name in (("180x240", "c420_q95.jpg"), ("1280x960", "frame_1280x960.jpg")):
        host = []
        for _ in range(9 if label == "180x240" else 5):
            t0 = time.perf_counter()
            kj.entropy_decode(files[name], name)
            host.append(1e3 * (time.perf_counter() - t0))
        out[label]["entropy_host_ms"] = statistics.median(host)
    work = [files[RATE[i % len(RATE)]] for i in range(256)]
    for threads in (1, 8):
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(lambda d: io.decode_img(d, "r", "cuda"), work[:64]))
            rates = []
            for _ in range(PASSES):
                t0 = time.perf_counter()
                list(pool.map(lambda d: io.decode_img(d, "r", "cuda"), work))
                rates.append(len(work) / (time.perf_counter() - t0))
            out[f"decode_img_s_threads_{threads}"] = statistics.median(rates)
            out[f"decode_img_s_threads_{threads}_passes"] = rates
    if batched:
        with ThreadPoolExecutor(max_workers=8) as pool:
            def decode64(chunk):
                prepared = list(pool.map(lambda d: io.prepare_img(d, "r", cuda), chunk))
                return io.finish_imgs(prepared, cuda)

            decode64(work[:64])
            rates = []
            for _ in range(PASSES):
                t0 = time.perf_counter()
                for s in range(0, len(work), 64):
                    decode64(work[s : s + 64])
                rates.append(len(work) / (time.perf_counter() - t0))
            out["decode_imgs_64_s_threads_8"] = statistics.median(rates)
            out["decode_imgs_64_s_threads_8_passes"] = rates
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
