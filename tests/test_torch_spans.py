"""The port's one tracer (``core/logging.py::StepTimer`` and its process-wide
event log) on the CPU: what it records while a ``torch.profiler`` profile
runs and what it does not without one; a ``/search`` through
``serving.serve`` split into its spans under one request id, with the
extractor's padding counted; a small training run's spans. The last test
holds the spans to the device trace's clock on a card and skips without
one. The module imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soft_contrastive_learning_torch import bench_train, serving
from soft_contrastive_learning_torch.core import logging as tracing
from soft_contrastive_learning_torch.core.config import (
    LossConfig, ModelConfig, TrainConfig, TupleConfig)
from soft_contrastive_learning_torch.core.logging import StepTimer, request_scope
from soft_contrastive_learning_torch.models.model import init_params

torch.set_num_threads(1)  # tier-1 runs several workers on one host

JPEG = Path(tracing.__file__).resolve().parents[1] / "assets" / "jpeg" / "c420_q95.jpg"


@pytest.fixture
def events(monkeypatch):
    """A fresh process-wide event log for the test."""
    log = tracing.EventLog()
    monkeypatch.setattr(tracing, "EVENTS", log)
    return log


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_by_default_records_no_event_and_keeps_totals(events):
    timer = StepTimer()
    assert not tracing.recording()
    with request_scope(3):
        with timer.span("a"):
            pass
        timer.count("c", 4)
    assert events.spans() == [] and events.counts() == []
    assert timer.summary()["a"]["count"] == 1 and timer.counts() == {"c": 4}


def test_recording_keeps_threads_requests_counts_and_the_unix_clock(events):
    timer = StepTimer()
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        with request_scope(11):
            with timer.span("worker"):
                timer.count("items", 2)

    with _cpu_profile() as prof:
        assert tracing.recording()
        with request_scope(7):
            before = time.time_ns()
            with timer.span("main"):
                time.sleep(0.002)
            after = time.time_ns()
            timer.count("items", 3)
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with timer.span("no_request"):
            pass
    assert not tracing.recording()
    with timer.span("after"):
        pass
    spans = {s[0]: s for s in events.spans()}
    assert set(spans) == {"main", "worker", "no_request"}
    name, tid, start, end, rid = spans["main"]
    assert (tid, rid) == (threading.get_native_id(), 7)
    assert before <= start < end <= after and end - start >= 2_000_000
    assert spans["worker"][1] == seen["tid"] and spans["worker"][4] == 11
    assert spans["no_request"][4] is None
    counts = sorted((c[0], c[3], c[4]) for c in events.counts())
    assert counts == [("items", 2, 11), ("items", 3, 7)]
    assert timer.counts() == {"items": 5}
    assert timer.summary()["main"]["count"] == 1 and "after" in timer.summary()
    # the span is a range of the profiler's own trace too (on the profiled thread)
    assert "main" in {e.name for e in prof.events()}
    # the window's bounds select what overlaps them
    assert [s[0] for s in events.spans(start, end)] == ["main"]


def test_threads_lose_no_total_and_no_event(events):
    """Many threads, a short switch interval: every span and count reaches
    the timer's totals and the event log."""
    timer = StepTimer()
    threads, per = 16, 400

    def worker(i):
        with request_scope(i):
            for _ in range(per):
                with timer.span("s"):
                    timer.count("c", 2)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            pool = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert timer.summary()["s"]["count"] == threads * per
    assert timer.counts() == {"c": 2 * threads * per}
    spans, counts = events.spans(), events.counts()
    assert len(spans) == len(counts) == threads * per
    assert {s[4] for s in spans} == set(range(threads)) == {c[4] for c in counts}


def test_threads_that_end_keep_their_totals():
    """A thread a request (as the HTTP server runs them): the totals of the
    threads that have ended are folded into the timer's, and the list of
    threads' totals holds only the live ones."""
    timer = StepTimer()

    def worker():
        with timer.span("s"):
            pass
        timer.count("c")

    for _ in range(50):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    worker()  # the main thread too
    assert timer.summary()["s"]["count"] == 51 and timer.counts() == {"c": 51}
    assert len(timer._threads) <= 2  # the main thread and the last worker at most


def test_a_new_profile_clears_the_last_ones_events(events):
    timer = StepTimer()
    with _cpu_profile():
        with timer.span("first"):
            pass
    with timer.span("between"):  # no profile: no event, the log left as it is
        timer.count("c")
    assert [s[0] for s in events.spans()] == ["first"] and not events.live
    with _cpu_profile():
        timer.count("c")
        with timer.span("second"):
            pass
    assert [s[0] for s in events.spans()] == ["second"]
    assert [c[0] for c in events.counts()] == ["c"]
    assert timer.summary()["first"]["count"] == 1 and timer.counts() == {"c": 2}


@pytest.fixture(scope="module")
def service():
    cfg = ModelConfig(vlad_cores=4, reduction="none", image_height=32, image_width=40,
                      compute_dtype="float32")
    index = np.random.default_rng(0).standard_normal((50, cfg.descriptor_dim)).astype(np.float32)
    svc = serving.DescriptorService(cfg, init_params(cfg, 0), batch_size=16, index=index,
                                    device="cpu")
    server = serving.serve(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield svc, server.server_address[1]
    server.shutdown()
    server.server_close()
    svc.extractor.close()


def _served(svc, before: int) -> None:
    """Wait until the handler has counted its request: the client may read
    the answer before the handler's last span ends."""
    deadline = time.monotonic() + 60
    while svc.timer.counts().get("serve.requests", 0) <= before:
        assert time.monotonic() < deadline, "the request was never counted"
        time.sleep(0.01)


def test_a_search_is_split_into_its_spans_under_one_request(service, events):
    svc, port = service
    body = json.dumps({"images_b64": [base64.b64encode(JPEG.read_bytes()).decode()] * 4,
                       "k": 3}).encode()
    before = svc.timer.counts().get("serve.requests", 0)
    with _cpu_profile():
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/search", data=body, method="POST"), timeout=300) as r:
            answer = json.loads(r.read())
        _served(svc, before)
    assert np.asarray(answer["indices"]).shape == (4, 3)
    rids = {s[4] for s in events.spans()}
    assert len(rids) == 1 and None not in rids
    spans = sorted(events.spans(), key=lambda s: s[2])
    assert len({s[1] for s in spans}) == 1  # all on the request's handler thread
    assert [s[0] for s in spans] == (
        ["serve.read", "serve.decode"] + ["decode.entropy"] * 4
        + ["decode.pixels", "serve.lock_wait", "serve.embed", "embed.prep", "embed.device",
           "serve.upload", "serve.lock_wait", "serve.search", "serve.respond"])
    # each stage starts after the one before it has ended, bar the spans nested in
    # decode and embed
    top = [s for s in spans if s[0].startswith("serve.")]
    assert all(a[3] <= b[2] for a, b in zip(top, top[1:]))
    counts = {c[0]: (c[3], c[4]) for c in events.counts()}
    rid = rids.pop()
    # one eager batch (the float path): no graph replay
    assert counts == {"embed.images": (4, rid), "embed.padded": (12, rid),
                      "embed.graph_replays": (0, rid), "serve.requests": (1, rid)}


def test_a_refused_upload_is_spanned_but_not_served(service, events):
    svc, port = service
    body = json.dumps({"images_b64": [base64.b64encode(b"not an image").decode()]}).encode()
    before = svc.timer.counts().get("serve.requests", 0)
    with _cpu_profile():
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/search", data=body, method="POST"), timeout=60)
        deadline = time.monotonic() + 60  # the handler's last span may end after the answer
        while "serve.respond" not in {s[0] for s in events.spans()}:
            assert time.monotonic() < deadline, "the answer was never spanned"
            time.sleep(0.01)
    assert err.value.code == 400
    assert [s[0] for s in sorted(events.spans(), key=lambda s: s[2])] == [
        "serve.read", "serve.decode", "serve.respond"]
    assert events.counts() == []  # a 400 is answered, not served
    assert svc.timer.counts().get("serve.requests", 0) == before


def _tiny_train_cfg() -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(vlad_cores=4, reduction="none", image_height=48, image_width=64,
                          compute_dtype="float32"),
        tuples=TupleConfig(positives_per_tuple=2, negatives_per_tuple=2,
                           hard_positives_per_tuple=1, hard_negatives_per_tuple=1),
        loss=LossConfig(name="wms"), tuples_per_batch=1, max_epoch=1,
        mining_step=8,  # 16 anchors: 2 segments an epoch
        mining_cache_size=8, eval_step=10**8, save_step=10**8, num_eval_queries=4,
        eval_ref_r=4, train_ref_r=1, seed=7)


def test_a_training_run_records_its_loop_and_its_syncs(tmp_path, events, monkeypatch):
    from soft_contrastive_learning_torch.train.trainer import Trainer

    trainers = []
    close = Trainer.close
    monkeypatch.setattr(Trainer, "close", lambda self: (trainers.append(self), close(self))[1])
    with _cpu_profile():
        res = bench_train.run(tuples_per_batch=1, num_points=16, use_cache=True, scan_iters=2,
                              out_dir=str(tmp_path), cfg=_tiny_train_cfg(), device="cpu")
    names = [s[0] for s in events.spans()]
    # two epochs (warm, timed) of two segments: a sync at each segment's two ends,
    # the losses fetched once a segment
    assert names.count("segment_sync") == 8 and names.count("scalar_fetch") == 4
    # each epoch's set-up and each segment's sampler
    assert names.count("epoch_setup") == 6
    assert names.count("train_step") == 32 and "mining_refresh" in names
    assert {s[1] for s in events.spans()} == {threading.get_native_id()}
    d = res["detail"]
    assert d["scalar_fetches"] == 2 and d["scalar_fetch_s"] >= 0.0
    assert "scalar_fetch" in d["spans"] and "segment_sync" in d["spans"]
    (tr,) = trainers
    assert not hasattr(tr, "scalar_fetches") and not hasattr(tr, "scalar_fetch_s")
    assert tr.timer.summary()["scalar_fetch"]["count"] == 2  # the timed epoch's timer


class _Spin(BaseHTTPRequestHandler):
    """Runs the card's work under a span on the handler's thread."""

    work = None

    def do_GET(self):
        type(self).work("card.handler")
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.mark.cuda
def test_spans_lie_on_the_device_traces_clock(monkeypatch):
    """A span around a launch and a sync, opened on the main thread and on
    an HTTP handler's, holds its kernel in the device trace of the same
    window: the kernel starts within 50 us of the launch's return and ends
    within 50 us of the span's end. Each window's offsets are the median of
    five spans a thread (the launch itself takes 20-65 us of host time under
    the profiler, and a thread can be descheduled at any time), and the test
    holds the median of five windows: in about one window in eight the
    profiler's own mapping of the card's timestamps to the host's clock is
    off by 0.1-0.6 ms for the whole window, whose host-side spans stay where
    they were. The trace is read on its own clock in every window (no shift
    of the device's operations to the window's start)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmarks.metrics._trace import DeviceProfiler, DeviceTrace

    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 28, device=dev)  # 1 GiB: a kernel of ~0.6 ms
    timer = StepTimer()

    def work(name, times=5):
        x.mul_(1.0)  # this thread's first launch, outside the spans
        torch.cuda.synchronize(dev)
        for _ in range(times):
            with timer.span(name):
                with timer.span(name + ".launch"):
                    x.mul_(1.0)
                torch.cuda.synchronize(dev)

    _Spin.work = staticmethod(work)
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Spin)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    shifted = []
    from_chrome = DeviceTrace.from_chrome.__func__

    def checked(cls, trace, start_ns, end_ns):
        base = int(trace.get("baseTimeNanoseconds", 0))
        ops = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() == "kernel"]
        inside = [e for e in ops if start_ns < base + float(e["ts"]) * 1e3 < end_ns]
        shifted.append(len(inside) < len(ops) / 2)
        return from_chrome(cls, trace, start_ns, end_ns)

    monkeypatch.setattr(DeviceTrace, "from_chrome", classmethod(checked))
    offsets = {"card.main": [], "card.handler": []}  # a window's (start, end) medians, ns
    threads = {}
    try:
        work("warm", 1)
        for _ in range(5):
            with DeviceProfiler() as prof:
                work("card.main")
                urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/",
                                       timeout=60).read()
            trace = prof.trace
            kernels = [op for op in trace.ops if op[3] == "kernel"]
            spans = tracing.EVENTS.spans(trace.start_ns, trace.end_ns)
            for name in offsets:
                outer = sorted(s for s in spans if s[0] == name)
                launches = sorted(s for s in spans if s[0] == name + ".launch")
                assert len(outer) == len(launches) == 5, (name, len(outer), len(launches))
                threads.setdefault(name, set()).update(s[1] for s in outer)
                starts, ends = [], []
                for (_, _, _, end, _), (_, _, _, launched, _) in zip(outer, launches):
                    # the span's kernel: the one that starts nearest the launch's return
                    _, k_start, k_end, _ = min(kernels, key=lambda k: abs(k[1] - launched))
                    starts.append(k_start - launched)
                    ends.append(end - k_end)
                offsets[name].append((np.median(starts), np.median(ends)))
    finally:
        server.shutdown()
        server.server_close()
    assert shifted == [False] * 5
    for name, windows in offsets.items():
        start, end = np.median(windows, axis=0)
        assert abs(start) <= 50_000 and abs(end) <= 50_000, (name, windows)
    main = threading.get_native_id()  # a request's handler runs on a thread of its own
    assert threads["card.main"] == {main} and main not in threads["card.handler"]
