"""The traffic is the same for one seed and differs for two, and every
seed gets the same amount of work."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmarks.traffic import closed_loop_search, open_loop_search

WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"


def params(name):
    return json.loads((WORKLOADS / f"{name}.json").read_text())["params"]


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_open_loop_schedule(seed):
    p = params("search-phone-pitts250k")
    a = open_loop_search.schedule(p, 20.0, seed, 48)
    assert a == open_loop_search.schedule(p, 20.0, seed, 48)
    b = open_loop_search.schedule(p, 20.0, seed + 1, 48)
    assert [r[1] for r in a] != [r[1] for r in b]  # other images
    assert [r[0] for r in a] == [r[0] for r in b]  # one trace of arrivals
    assert len(a) == round(p["rate_per_s"] * 20.0)
    gaps = np.diff([r[0] for r in a])
    assert abs(gaps.mean() * p["rate_per_s"] - 1) < 0.02 and gaps.std() / gaps.mean() > 0.9
    assert all(0.0 <= r[0] < 20.0 for r in a)
    assert all(len(r[1]) == p["images_per_request"] and r[2] == p["k"] for r in a)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_closed_loop_clients(seed):
    p = params("search-fleet-pitts250k")
    a = closed_loop_search.clients(p, 20.0, seed, 48)
    assert a == closed_loop_search.clients(p, 20.0, seed, 48)
    assert a != closed_loop_search.clients(p, 20.0, seed + 1, 48)
    assert len(a) == p["clients"]
    for reqs in a:
        assert all(len(ids) == p["images_per_request"] and k == p["k"] for ids, k in reqs)
        first = reqs[0][0]
        assert reqs[1][0] == [(i + 1) % 48 for i in first]  # the vehicle's next frames
