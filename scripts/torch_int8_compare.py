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
* the stem: conv1_1 from the uint8 images, the input's requant included
  (``int8_conv.int8_stem`` where the tree has it; else the requant and
  ``stem_columns`` in torch ops, then Q1 on the packed columns), and, where
  the tree packs columns in torch ops, that packing on its own;
* Q1 on each later layer (conv1_2 .. conv5_3), fed the stack's own maps.

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
    from soft_contrastive_learning_torch.models import quant
    from soft_contrastive_learning_torch.models.quant import CONV_NAMES, QuantizedEmbedder
    from soft_contrastive_learning_torch.ops.kernels import int8_conv as q1

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
    stack = emb.stack
    stem = stack.layers[0]
    tail = (stem["weight"], stem["mult"], stem["bias"], stem["inv_next"], stem["relu"])
    if hasattr(q1, "int8_stem"):  # the stem in one kernel
        def run_stem(x):
            return q1.int8_stem(x, stack.average_rgb, stack.inv_in, *tail)

        def requant(x):
            return None
    else:  # the input's requant and the packed columns in torch ops, then Q1
        def requant(x):
            return quant._requant(quant._images(x) - stack.average_rgb, stack.scale_in)

        def run_stem(x):
            return q1.int8_conv(q1.stem_columns(requant(x)), *tail, stem["out_f32"])

    u8 = np.random.default_rng(0).integers(
        0, 256, (flagship.SERVING_BATCH, cfg.image_height, cfg.image_width, 3), np.uint8)
    x_all = torch.from_numpy(u8).cuda()
    out = dict(label=args.label or str(root), params=provenance)
    for b, reps in ((64, 10), (flagship.SERVING_BATCH, 3)):
        x = x_all[:b]
        row = dict(forward_ms=time_ms(torch, lambda: emb(x), reps),
                   stem_ms=time_ms(torch, lambda: run_stem(x), reps))
        raw = requant(x)
        if raw is not None:
            row["stem_columns_ms"] = time_ms(torch, lambda: q1.stem_columns(raw), reps)
        del raw
        a8, layers = run_stem(x), {}
        for name, layer in zip(CONV_NAMES[1:], stack.layers[1:]):
            largs = (layer["weight"], layer["mult"], layer["bias"], layer["inv_next"],
                     layer["relu"], layer["out_f32"])
            layers[name] = time_ms(torch, lambda: q1.int8_conv(a8, *largs), reps)
            y = q1.int8_conv(a8, *largs)
            a8 = q1.int8_pool(y) if layer["pool"] else y
        del a8, y
        row["q1_layers_ms"] = layers
        row["q1_ms"] = sum(layers.values())
        out[f"B{b}"] = row
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
