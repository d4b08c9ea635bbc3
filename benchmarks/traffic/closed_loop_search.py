"""Closed loop of ``POST /search``: ``clients`` callers, each sending its
next request when the reply to the last one came. Client c is a vehicle
that drives through the upload pool from a seeded start, and asks with its
last ``images_per_request`` frames. The rate is the requests completed in
the window over the window.

Parameters: ``clients``, ``images_per_request``, ``k``."""

from __future__ import annotations

import math
from typing import List

import numpy as np

from benchmarks.harness import Outcome
from benchmarks.traffic._search import SearchRig

MAX_RATE_PER_CLIENT = 40.0  # requests a second a client could send at most


def clients(params: dict, seconds: float, seed: int, pool: int) -> List[List[list]]:
    """Each client's requests, ``[[image ids], k]``, in order."""
    m, k = int(params["images_per_request"]), int(params["k"])
    starts = np.random.default_rng(seed).permutation(pool)[: int(params["clients"])]
    n = int(math.ceil(seconds * MAX_RATE_PER_CLIENT))
    return [[[[int((s + j + f) % pool) for f in range(m)], k] for j in range(n)]
            for s in starts]


def run(cell) -> Outcome:
    p = cell.params
    rig = SearchRig(cell, int(p["images_per_request"]), int(p["k"]))
    t0_wall, rows, trace = rig.window({"clients": clients(p, cell.seconds, cell.seed, rig.uploads.pool),
                                       "grace_s": 60.0})
    setup_s = t0_wall - cell.started
    ok = [r for r in rows if r[3] == 200 and r[2] is not None]
    in_window = [r for r in ok if r[2] <= cell.seconds]
    peak = rig.close_program()
    queries = rig.reference_descriptors()
    dist_gap, rank_gap, malformed = rig.judge(ok, queries, lambda r: r[6])
    failed = len(rows) - len(ok) + malformed
    limits = cell.params["limits"]
    checks = [("failed", failed, 0), ("dist_gap", dist_gap, limits["dist_gap"]),
              ("rank_gap", rank_gap, limits["rank_gap"])]
    return Outcome(
        correct=all(v <= lim for _, v, lim in checks) and bool(in_window),
        attempted=len(rows), failed=failed,
        e2e={"search_per_s": len(in_window) / cell.seconds, "setup_s": setup_s},
        checks=checks,
        readings={"kind": "search", "spans": rig.spans, "trace": trace, "rows": in_window,
                  "served": len(ok),
                  "embed_self_s": rig.embed_self_s, "images_per_request": rig.images_per_request,
                  "k": rig.k, "index_shape": tuple(rig.index.shape), "config": cell.config,
                  "seconds": cell.seconds},
        memory_peak_bytes=peak, trace=trace)
