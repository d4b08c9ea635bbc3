#!/usr/bin/env python3
"""Time the int8-PTQ forward of the flagship (VGG16 + NetVLAD-64 at 180x240,
the trained weights) of one tree of the PyTorch port on one CUDA card.

    python3 scripts/torch_int8_compare.py [--root DIR] [--label NAME]

``--root`` is a directory holding a ``soft_contrastive_learning_torch``
package and the trained npz (default: this checkout), for instance an
unpacked ``git archive`` of another commit; its kernels build into that
tree. Run two trees in turns (A, B, B, A) on the same card to compare them.
At B = 64 and 1,536 on seeded uint8 images it times, by CUDA events:

* the whole forward (``QuantizedEmbedder``, calibrated on
  ``flagship.calibration_images``);
* the stem's packed columns (``int8_conv.stem_columns``) of the requantized
  input, on their own.

Prints the card's name and power limit, then one JSON line. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import soft_contrastive_learning_torch as port
    from soft_contrastive_learning_torch import flagship
    from soft_contrastive_learning_torch.models.quant import (
        QuantizedEmbedder, _images, _requant)
    from soft_contrastive_learning_torch.ops.kernels.int8_conv import stem_columns

    if not Path(port.__file__).resolve().is_relative_to(root):
        print(f"imported the port from {port.__file__}, not from {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = flagship.flagship_model_config()
    params, provenance = flagship.flagship_params(cfg)
    emb = QuantizedEmbedder(cfg, params, flagship.calibration_images(cfg), device="cuda")
    u8 = np.random.default_rng(0).integers(
        0, 256, (flagship.SERVING_BATCH, cfg.image_height, cfg.image_width, 3), np.uint8)
    x_all = torch.from_numpy(u8).cuda()
    out = dict(label=args.label or str(root), params=provenance)
    for b, reps in ((64, 10), (flagship.SERVING_BATCH, 3)):
        x = x_all[:b]
        raw = _requant(_images(x) - emb.stack.average_rgb, emb.stack.scale_in)
        out[f"B{b}"] = dict(forward_ms=time_ms(torch, lambda: emb(x), reps),
                            stem_columns_ms=time_ms(torch, lambda: stem_columns(raw), reps))
        del raw
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
