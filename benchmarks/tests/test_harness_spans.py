"""The readers of the program's own spans and counts (``metrics/_spans.py``
and the six metrics that read it) on a synthetic device trace and a
synthetic event log; and on a program without that log, where they read
nothing."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmarks import run
from benchmarks.metrics._spans import overlap_ns
from benchmarks.metrics._trace import DeviceTrace
from soft_contrastive_learning_torch.core import logging as tracing

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = ("queue_ms.fleet", "http_ms.fleet", "embed_pad_share.fleet", "idle_unattributed.fleet",
       "loop_idle_ms.train", "idle_unattributed.train")
US = 1000  # ns


def _trace() -> DeviceTrace:
    """A window of 0..1000 us, kernels at 100-300, 500-600 and 800-1000: idle
    0-100, 300-500 and 600-800."""
    ops = [("k", a * US, b * US, "kernel") for a, b in ((100, 300), (500, 600), (800, 1000))]
    return DeviceTrace(ops, 0, 1000 * US)


@pytest.fixture
def log(monkeypatch):
    ev = tracing.EventLog()
    ev.offset_ns = 0
    monkeypatch.setattr(tracing, "EVENTS", ev)
    return ev


def _span(log, name, tid, a, b, rid=None):
    log._spans.append((name, tid, a * US, b * US, rid))


def _count(log, name, at, n, rid=None):
    log._counts.append((name, 1, at * US, n, rid))


def _read(metric, readings):
    return run.find_reader(metric).read(metric, readings)


def test_the_six_entries_are_the_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"][-6:]] == list(NEW)
    for name in NEW:
        cell = "train-wms-toycity" if name.endswith(".train") else "search-fleet-pitts250k"
        assert entries[name]["workloads"] == [cell]
        assert name in {m["name"] for m in run.cell_metrics(BENCH, cell, trace=True)}


def test_search_readers(log):
    _span(log, "serve.lock_wait", 1, 0, 150, 1)
    _span(log, "serve.read", 2, 350, 400, 2)
    _span(log, "serve.respond", 2, 400, 450, 2)
    _span(log, "serve.lock_wait", 3, 900, 1100, 3)  # clipped at the window's end
    _span(log, "serve.lock_wait", 3, 1200, 1300, 4)  # after the window
    _count(log, "serve.requests", 450, 1, 2)
    _count(log, "serve.requests", 999, 1, 1)
    _count(log, "serve.requests", 1300, 1, 4)
    _count(log, "embed.images", 200, 4, 1)
    _count(log, "embed.padded", 200, 12, 1)
    r = {"kind": "search", "trace": _trace()}
    assert _read("queue_ms.fleet", r) == pytest.approx((150 + 100) / 2 / 1000)
    assert _read("http_ms.fleet", r) == pytest.approx((50 + 50) / 2 / 1000)
    assert _read("embed_pad_share.fleet", r) == pytest.approx(75.0)
    # of 500 us idle, 0-100 under a lock wait and 350-450 under the HTTP spans
    assert _read("idle_unattributed.fleet", r) == pytest.approx(60.0)
    assert _read("loop_idle_ms.train", r) is None


def test_train_readers(log):
    _span(log, "epoch_setup", 5, 0, 20)
    _span(log, "train_step", 5, 20, 50)
    _span(log, "host_build", 5, 50, 120)
    _span(log, "host_build", 6, 300, 500)  # another thread's: not the loop's
    _span(log, "eval_loss", 5, 600, 800)  # the loop's thread, not a loop span
    r = {"kind": "train", "trace": _trace(), "steps": 4}
    # the loop's thread in a loop span over 20-100 of the idle time
    assert _read("loop_idle_ms.train", r) == pytest.approx(80 / 4 / 1000)
    assert _read("idle_unattributed.train", r) == pytest.approx(0.0)
    assert _read("queue_ms.fleet", r) is None


def test_nothing_to_read(log, monkeypatch):
    r = {"kind": "search", "trace": _trace(), "steps": 3}
    assert all(_read(m, r) is None for m in NEW)  # an empty log
    _span(log, "serve.read", 2, 350, 400, 2)
    assert all(_read(m, dict(r, trace=None)) is None for m in NEW)  # an untraced run
    monkeypatch.delattr(tracing, "EVENTS")  # a program that keeps no event log
    assert all(_read(m, r) is None for m in NEW)


def test_overlap():
    assert overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert overlap_ns([(0, 10)], []) == 0
    assert overlap_ns([(0, 100)], [(10, 20), (30, 40), (90, 200)]) == 30
