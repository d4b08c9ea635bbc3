"""The trace reader on small traces in the profiler's chrome format: one
written here, and one that the profiler recorded on the card."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmarks.metrics import _trace
from benchmarks.metrics._trace import DEVICE_CATS, DeviceTrace, kernel_id

FIXTURES = Path(__file__).parent / "fixtures"
SMALL = json.loads((FIXTURES / "trace_small.json").read_text())
BASE = SMALL["baseTimeNanoseconds"]
EVENTS = SMALL["traceEvents"]


def trace(start_us=0.0, end_us=12_000.0):
    return DeviceTrace.from_chrome(SMALL, BASE + int(start_us * 1e3), BASE + int(end_us * 1e3))


def test_ids():
    names = [e["name"] for e in EVENTS if e["cat"] == "kernel"]
    assert [kernel_id(n) for n in names] == ["Q1_stem", "Q1", "Q1_pool", "K1", "K2", "K2", "K2",
                                             "K1", "K1", "K3"]


def test_only_the_devices_kernels_copies_and_sets_are_read():
    t = trace()
    cats = sorted({c for _, _, _, c in t.ops})
    assert cats == ["gpu_memcpy", "gpu_memset", "kernel"]
    names = {n for n, _, _, _ in t.ops}
    # a host operator, a launch call and an annotation mirrored on the device are not device work
    assert not {"aten::add", "cudaLaunchKernel", "step"} & names
    assert len(t.ops) == len(EVENTS) - 3


def test_a_trace_recorded_on_the_card():
    """The profiler's own trace of a product, a set and a copy inside an
    annotation (CPU and CUDA activity, torch on the card's machine): the
    reader keeps one of each device operation and nothing of the host's."""
    card = json.loads((FIXTURES / "trace_card.json").read_text())
    events = [e for e in card["traceEvents"] if e.get("ph") == "X"]
    start = min(int(card.get("baseTimeNanoseconds", 0)) + int(float(e["ts"]) * 1e3)
                for e in events)
    t = DeviceTrace.from_chrome(card, start, start + 10**10)
    cats = {c for _, _, _, c in t.ops}
    assert cats == set(DEVICE_CATS)
    on_device = [e for e in events if e["cat"].lower() in DEVICE_CATS]
    assert len(t.ops) == len(on_device) < len(events)
    assert 0 < t.busy_s() < t.window_s


def test_busy_idle_and_ids():
    t = trace()
    # kernels 50 + 100 + 10 + 20 + 5 + 9000 + 15 + 40 + 4 + 20 us; the copy overlaps 240..270;
    # the set 10 us
    assert t.busy_s() == pytest.approx((170 + 20 + 9020 + 44 + 20 + 10) * 1e-6)
    assert t.idle_share() == pytest.approx(1 - t.busy_s() / 0.012)
    assert t.kernel_s() == pytest.approx(9264e-6)
    ids = t.by_id()
    assert ids["K2"]["launches"] == 3 and ids["K2.calls"]["launches"] == 1
    assert ids["K2.calls"]["seconds"] == pytest.approx(9020e-6)
    assert ids["K1.fwd"]["launches"] == 1 and ids["K1.bwd"]["launches"] == 1
    assert ids["K1.bwd"]["seconds"] == pytest.approx(44e-6)
    assert ids["K3"]["launches"] == 1


def test_window_clips_and_breakdown():
    t = trace(200.0, 1100.0)
    assert t.window_s == pytest.approx(900e-6)
    assert t.busy_s() == pytest.approx((50 + 20 + 20 + 5 + 95) * 1e-6)
    spans = [("embed", BASE + 300_000, BASE + 900_000), ("lock_wait", BASE + 500_000,
                                                          BASE + 800_000)]
    b = t.breakdown(spans)
    assert b["device_ops"][0][0].startswith("K2") and len(b["device_ops"]) <= 10
    label, seconds = b["idle_gaps"][0]
    assert label == "lock_wait+embed" and seconds == pytest.approx(580e-6)


def test_other_clock_is_aligned():
    start = 10**18
    t = DeviceTrace.from_chrome(dict(SMALL, baseTimeNanoseconds=0), start, start + 12_000_000)
    assert t.busy_s() == pytest.approx(trace().busy_s())
    assert min(s for _, s, _, _ in t.ops) == start


def test_union():
    assert _trace.union_length([(0, 2), (1, 3), (5, 6)]) == (4, [(0, 3), (5, 6)])
