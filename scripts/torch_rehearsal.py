#!/usr/bin/env python3
"""The paper-results rehearsal through the port's command line on one card:
descriptor inference -> PCA-whitened top-N sweep -> ROC curves, at the full
protocol of ``docs/REHEARSAL.md``.

1. render the rehearsal corpus (``data/corpus.py``: toy_pca 4,400,
   toy_ref 3,000, toy_query 300 images at 180x240, the geometry of
   ``perf/rehearsal_corpus.py``) with the port's PNG writer on a pool of
   processes;
2. ``infer`` each set with the committed trained flagship (32,768-D fp32
   dumps, batch 32);
3. ``topn``: one whitening fit at D = 4,096, D in {64 ... 4096} x L in
   {0, 0.3, 1, 5} m, N = 25 (28 settings);
4. the ROC curves (``correctly_localized_curve``) of every setting, and
   ``roc`` figures where matplotlib is installed.

It prints the card's name and power limit, each stage's wall time, and per
setting the share of queries whose top-1 lies within 5, 10 and 25 m beside
the same aggregate of the committed sweep in ``perf/rehearsal_artifacts/
top_n/`` (made by the JAX package from bf16 dumps on a TPU: compare
aggregates only). The last line is a JSON object of the stage times and the
aggregates. Run from the repository root:

    python3 scripts/torch_rehearsal.py [work_dir] [--device cuda]

``work_dir`` (default: a temporary directory, removed at the end) keeps the
corpus, the dumps (about 1 GB) and the pickles when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DIMS = (64, 128, 256, 512, 1024, 2048, 4096)
SPACINGS = (0.0, 0.3, 1.0, 5.0)
SIZES = dict(n_ref=3000, n_query=300, n_pca=4400)


def aggregates(pickle_path):
    """% of queries whose top-1 lies within 5, 10 and 25 m, and the mean of
    the 0-25 m curve."""
    import numpy as np

    from soft_contrastive_learning_torch.evaluation.roc import (
        correctly_localized_curve,
        load_top1_dists,
    )

    top1, gt = load_top1_dists(pickle_path)
    _, y = correctly_localized_curve(top1)
    return {"within_5m": float((top1 < 5).mean() * 100),
            "within_10m": float((top1 < 10).mean() * 100),
            "within_25m": float((top1 < 25).mean() * 100), "curve_mean": float(y.mean()),
            "bound_within_5m": float((np.asarray(gt) < 5).mean() * 100)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("work_dir", nargs="?", default="")
    parser.add_argument("--device", default="cuda", help="torch device; 'cpu' only when asked")
    parser.add_argument("--workers", type=int, default=8, help="rendering processes")
    args = parser.parse_args(argv)

    from soft_contrastive_learning_torch import cli
    from soft_contrastive_learning_torch.data.corpus import rehearsal_sets, write_image_set

    if args.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    tmp = None if args.work_dir else tempfile.TemporaryDirectory()
    root = Path(args.work_dir or tmp.name)
    img_root, csv_root, lv = root / "imgs", root / "lists", root / "lv"
    top_n, figs = root / "top_n", root / "figs"
    times = {}

    sets = rehearsal_sets(**SIZES)
    for name, city in sets.items():
        t0 = time.perf_counter()
        write_image_set(city, name, str(img_root), str(csv_root), workers=args.workers)
        times[f"render_{name}"] = time.perf_counter() - t0
        print(f"render {name}: {len(city)} images in {times[f'render_{name}']:.1f} s", flush=True)

    for name in ("toy_pca", "toy_ref", "toy_query"):
        t0 = time.perf_counter()
        rc = cli.main(["infer", "--set", name, "--csv_root", str(csv_root), "--img_root",
                       str(img_root), "--out_root", str(lv), "--out_name", "wms",
                       "--device", args.device])
        times[f"infer_{name}"] = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"infer {name} failed")
        size = os.path.getsize(lv / f"{name}_wms.pickle")
        print(f"infer {name}: {len(sets[name])} images in {times[f'infer_{name}']:.1f} s "
              f"({len(sets[name]) / times[f'infer_{name}']:.1f} img/s), {size / 1e6:.0f} MB",
              flush=True)

    t0 = time.perf_counter()
    rc = cli.main(["topn", "--pca_lv_pickle", str(lv / "toy_pca_wms.pickle"),
                   "--ref_lv_pickle", str(lv / "toy_ref_wms.pickle"),
                   "--query_lv_pickle", str(lv / "toy_query_wms.pickle"),
                   "--ref_csv", str(csv_root / "toy_ref.csv"),
                   "--query_csv", str(csv_root / "toy_query.csv"), "--out_root", str(top_n),
                   "--N", "25", "--dims", ",".join(map(str, DIMS)),
                   "--spacings", ",".join(map(str, SPACINGS)), "--device", args.device])
    times["topn_sweep"] = time.perf_counter() - t0
    settings = sorted(p.parent.name for p in top_n.glob("*/toy_query_wms.pickle"))
    if rc != 0 or len(settings) != len(DIMS) * len(SPACINGS):
        raise SystemExit(f"topn: rc {rc}, {len(settings)} settings")
    print(f"topn: {len(settings)} settings in {times['topn_sweep']:.1f} s", flush=True)

    t0 = time.perf_counter()
    committed = ROOT / "perf" / "rehearsal_artifacts" / "top_n"
    rows = {}
    for setting in settings:
        rows[setting] = {"port": aggregates(str(top_n / setting / "toy_query_wms.pickle"))}
        ref = committed / setting / "toy_query_wms.pickle"
        rows[setting]["committed"] = aggregates(str(ref)) if ref.exists() else None
    times["roc_curves"] = time.perf_counter() - t0
    if importlib.util.find_spec("matplotlib") is not None:
        for l, d in (("0.0", 256), ("5.0", 4096)):
            t0 = time.perf_counter()
            cli.main(["roc", "--top_n_root", str(top_n), "--out_root", str(figs), "--l", l,
                      "--d", str(d), "--queries", "toy_query"])
            times[f"roc_l{l}_dim{d}"] = time.perf_counter() - t0
    else:
        print("roc: matplotlib is not installed, so no figure; the curves are "
              "correctly_localized_curve's", flush=True)

    print("setting           %<5m  %<10m  %<25m  curve | committed %<5m  %<10m  %<25m  curve "
          "| bound %<5m", flush=True)
    for setting, row in rows.items():
        p, c = row["port"], row["committed"]
        theirs = (f"{c['within_5m']:5.1f} {c['within_10m']:6.1f} {c['within_25m']:6.1f} "
                  f"{c['curve_mean']:6.2f}" if c else "  (none)")
        print(f"{setting:16s} {p['within_5m']:5.1f} {p['within_10m']:6.1f} {p['within_25m']:6.1f} "
              f"{p['curve_mean']:6.2f} | {theirs} | {p['bound_within_5m']:5.1f}", flush=True)
    print("stage times (s): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()), flush=True)
    print(json.dumps({"times_s": times, "settings": rows}))
    if tmp is not None:
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
