"""The reader of ``embed_graph_share.fleet`` (``metrics/embed_graph_share.py``)
on a synthetic device trace and a synthetic event log: all batches replayed,
none replayed, and a program that never counts replays or ran no images,
where it reads nothing."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmarks import run
from benchmarks.metrics._trace import DeviceTrace
from soft_contrastive_learning_torch.core import logging as tracing

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
METRIC = "embed_graph_share.fleet"
CELL = "search-fleet-pitts250k"
US = 1000  # ns


@pytest.fixture
def log(monkeypatch):
    ev = tracing.EventLog()
    ev.offset_ns = 0
    monkeypatch.setattr(tracing, "EVENTS", ev)
    return ev


def _count(log, name, at, n):
    log._counts.append((name, 1, at * US, n, None))


def _reading(trace=True):
    ops = [("k", 100 * US, 900 * US, "kernel")]
    return {"kind": "search", "trace": DeviceTrace(ops, 0, 1000 * US) if trace else None,
            "config": {"batch_size": 16}}


def test_the_entry_is_the_fleet_cell():
    entry = {m["name"]: m for m in BENCH["per_layer"]}[METRIC]
    assert entry["workloads"] == [CELL]
    assert METRIC in {m["name"] for m in run.cell_metrics(BENCH, CELL, trace=True)}


@pytest.mark.parametrize("replays,images,want", [(1, True, 100.0), (0, True, 0.0),
                                                  (None, True, None), (0, False, None)])
def test_embed_graph_share(log, replays, images, want):
    """Two batches of 16 (4 and 16 images asked for): both replayed, both
    eager (counted 0), a program that never counts replays, or replays
    counted with no images."""
    for at, n in ((200, 4), (600, 16)):
        if images:
            _count(log, "embed.images", at, n)
            _count(log, "embed.padded", at, 16 - n)
        if replays is not None:
            _count(log, "embed.graph_replays", at, replays)
    got = run.find_reader(METRIC).read(METRIC, _reading())
    assert got == (want if want is None else pytest.approx(want))
    assert run.find_reader(METRIC).read(METRIC, _reading(trace=False)) is None


def test_no_event_log(log, monkeypatch):
    _count(log, "embed.images", 200, 16)
    _count(log, "embed.graph_replays", 200, 1)
    monkeypatch.delattr(tracing, "EVENTS")  # a program that keeps no event log
    assert run.find_reader(METRIC).read(METRIC, _reading()) is None
