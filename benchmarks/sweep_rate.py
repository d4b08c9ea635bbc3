"""Finds the highest rate an open-loop search cell sustains: one set-up,
then a window at each offered rate, reporting the completion rate, the
median and 95th-percentile latency, and the mean latency of the window's
last quarter of requests over its first quarter (a growing backlog shows
as a ratio that climbs with the rate). The cell's rate is then fixed at
about four fifths of the highest sustained one::

    python3 -m benchmarks.sweep_rate --workload search-phone-pitts250k --seed 7 \
        --seconds 10 --rates 40,50,60,70,80
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> None:
    import torch

    from benchmarks import run
    from benchmarks.harness import Cell, process_start_s
    from benchmarks.traffic import open_loop_search
    from benchmarks.traffic._search import SearchRig

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    workload = run.find_workload(args.workload)
    work = run.ROOT / "_work" / args.workload
    work.mkdir(parents=True, exist_ok=True)
    run.set_cache_dirs(run.ROOT / "_work")
    cell = Cell(name=args.workload, config=run.find_config(workload["config"]),
                params=workload["params"], seed=args.seed, seconds=args.seconds, trace=False,
                device=torch.device("cuda", 0), work_dir=work, started=process_start_s())
    p = cell.params
    rig = SearchRig(cell, int(p["images_per_request"]), int(p["k"]))
    for rate in (float(r) for r in args.rates.split(",")):
        sched = open_loop_search.schedule(dict(p, rate_per_s=rate), args.seconds, args.seed,
                                          rig.uploads.pool)
        _, rows, _ = rig.window({"schedule": sched, "grace_s": 60.0})
        ok = [r for r in rows if r[3] == 200 and r[2] is not None]
        lat = np.array([r[2] - r[0] for r in ok])
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate": rate, "sent": len(sched), "ok": len(ok),
            "completed_per_s": len(ok) / max(r[2] for r in ok),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "last_over_first_quarter": float(lat[-q:].mean() / lat[:q].mean())}), flush=True)
    rig.close_program()


if __name__ == "__main__":
    main()
