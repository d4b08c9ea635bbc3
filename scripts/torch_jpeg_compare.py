#!/usr/bin/env python3
"""Time the JPEG path (the host entropy decoder, J1 and ``decode_img``) of
one tree of the PyTorch port on one CUDA card.

    python3 scripts/torch_jpeg_compare.py [--root DIR] [--label NAME]

``--root`` is a directory holding a ``soft_contrastive_learning_torch``
package (default: this checkout), for instance an unpacked ``git archive``
of another commit; its kernels build into that tree. Run two trees in turns
in one process list (A, B, B, A) on the same card to compare them. The
files are this checkout's original 180x240 fixtures and 1280x960 frame
(``assets/jpeg``), whichever tree is timed, and the calls are those every
tree since J1 has
(``entropy_decode(data, path)``, ``jpeg_pixels_cuda``, ``decode_img(data,
path, device)``):

* ``decode_img`` on the card, one thread, img/s over 256 decodes of the
  seventeen 180x240 fixtures (as ``chip_smoke.py``'s ``jpeg`` phase);
* the host entropy decode, ms (median of 9 at 180x240, of 5 at 1280x960);
* J1 at 180x240 (4:2:0) and 1280x960: ms a call back to back (CUDA
  events), and the same calls' host time (no sync) and device time (queued
  behind a ``torch.cuda._sleep``).

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

HERE = Path(__file__).resolve().parents[1] / "soft_contrastive_learning_torch" / "assets" / "jpeg"
RATE = ("adobe_rgb.jpg", "c411.jpg", "c420_q95.jpg", "c422.jpg", "c440.jpg", "c444.jpg",
        "gray.jpg", "orient2.jpg", "orient3.jpg", "orient4.jpg", "orient5.jpg", "orient6.jpg",
        "orient7.jpg", "orient8.jpg", "progressive_cv2.jpg", "progressive_pil.jpg", "restart3.jpg")


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

    import torch

    import soft_contrastive_learning_torch as port
    from soft_contrastive_learning_torch.ops.kernels import _build
    from soft_contrastive_learning_torch.ops.kernels.jpeg import entropy_decode, jpeg_pixels_cuda
    from soft_contrastive_learning_torch.utils.io import decode_img

    if not Path(port.__file__).resolve().is_relative_to(root):
        print(f"imported the port from {port.__file__}, not from {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    out = dict(label=args.label or str(root), build_s=_build.build(["jpeg"]))
    files = {n: (HERE / n).read_bytes() for n in (*RATE, "frame_1280x960.jpg")}
    work = [files[RATE[i % len(RATE)]] for i in range(256)]
    for data in work[:16]:
        decode_img(data, "r", "cuda")
    t0 = time.perf_counter()
    for data in work:
        decode_img(data, "r", "cuda")
    out["decode_img_s"] = len(work) / (time.perf_counter() - t0)
    for label, name in (("180x240", "c420_q95.jpg"), ("1280x960", "frame_1280x960.jpg")):
        host = []
        for _ in range(9 if label == "180x240" else 5):
            t0 = time.perf_counter()
            co = entropy_decode(files[name], name)
            host.append(1e3 * (time.perf_counter() - t0))
        coefs, quant = torch.from_numpy(co.coefs).cuda(), torch.from_numpy(co.quant).cuda()
        call = lambda: jpeg_pixels_cuda(coefs, quant, co.frame)  # noqa: E731
        host_ms, device_ms = host_and_device_ms(torch, call, 50)
        out[label] = dict(entropy_host_ms=statistics.median(host), j1_ms=time_ms(torch, call, 50),
                          j1_host_ms=host_ms, j1_device_ms=device_ms)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
