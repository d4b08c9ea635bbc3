"""Open loop of ``POST /search``: independent users, each request sent at
its due time whatever came back before it. Arrivals are Poisson at
``rate_per_s``: one trace of arrivals for every run (the exponential's
quantiles, scaled to fill the window, in the order of a fixed draw,
``arrival_seed``), so that a tail measured near capacity does not swing
with the trace; what each request sends (its images from the upload
pool) is drawn from the run's seed. Latency runs from a request's due
time to its full response; a request that failed counts as missing
(infinite).

Parameters: ``rate_per_s``, ``images_per_request``, ``k``, ``arrival_seed``."""

from __future__ import annotations

import math
import sys
from typing import List

import numpy as np

from benchmarks.harness import Outcome
from benchmarks.traffic._search import SearchRig


def schedule(params: dict, seconds: float, seed: int, pool: int) -> List[list]:
    """``[due_s, [image ids], k]`` per request, ascending due, all in [0, seconds)."""
    n = max(1, int(round(params["rate_per_s"] * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)  # the unit exponential's quantiles
    gaps *= seconds / gaps.sum()
    order_seed = params.get("arrival_seed")
    gaps = np.random.default_rng(seed if order_seed is None else int(order_seed)).permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    m = int(params["images_per_request"])
    images = np.random.default_rng(seed).integers(0, pool, size=(n, m))
    return [[float(d), [int(i) for i in row], int(params["k"])] for d, row in zip(due, images)]


def run(cell) -> Outcome:
    p = cell.params
    rig = SearchRig(cell, int(p["images_per_request"]), int(p["k"]))
    sched = schedule(p, cell.seconds, cell.seed, rig.uploads.pool)
    t0_wall, rows, trace = rig.window({"schedule": sched, "grace_s": 60.0})
    setup_s = t0_wall - cell.started
    ok = [r for r in rows if r[3] == 200 and r[2] is not None]
    latency = sorted((r[2] - r[0]) if (r[3] == 200 and r[2] is not None) else math.inf
                     for r in rows)
    latency += [math.inf] * (len(sched) - len(rows))
    late = [r[1] - r[0] for r in rows]
    finite = [v for v in latency if math.isfinite(v)]
    if finite:
        print("latency ms p50 %.1f p90 %.1f p99 %.1f max %.1f; generator late max %.1f ms"
              % tuple([float(np.percentile(finite, q)) * 1e3 for q in (50, 90, 99, 100)]
                      + [max(late, default=0.0) * 1e3]), file=sys.stderr)
    peak = rig.close_program()
    queries = rig.reference_descriptors()
    dist_gap, rank_gap, malformed = rig.judge(ok, queries, lambda r: r[6])
    failed = len(sched) - len(ok) + malformed
    limits = cell.params["limits"]
    checks = [("failed", failed, 0), ("dist_gap", dist_gap, limits["dist_gap"]),
              ("rank_gap", rank_gap, limits["rank_gap"])]
    p95 = float(np.percentile(latency, 95)) * 1e3 if latency else math.inf
    return Outcome(
        correct=all(v <= lim for _, v, lim in checks) and math.isfinite(p95),
        attempted=len(sched), failed=failed,
        e2e={"search_p95_ms": p95, "setup_s": setup_s},
        checks=checks,
        readings={"kind": "search", "mfu_per_request": True, "spans": rig.spans, "trace": trace,
                  "rows": ok, "served": len(ok),
                  "embed_self_s": rig.embed_self_s, "images_per_request": rig.images_per_request,
                  "k": rig.k, "index_shape": tuple(rig.index.shape), "config": cell.config,
                  "seconds": cell.seconds, "late_max_s": max(late, default=0.0),
                  "late_p99_s": float(np.percentile(late, 99)) if late else 0.0},
        memory_peak_bytes=peak, trace=trace)
