"""Where a benchmark cell's device idle time goes, by the program's own spans,
and what recording them costs.

    python scripts/torch_trace_split.py split --workload <cell> --seed <n> --seconds <s>
    python scripts/torch_trace_split.py one --workload <cell> --seed <n> --seconds <s> \\
        --record on|off

``split`` runs the cell traced (as ``benchmarks/run.py --trace 1`` does) and
prints one JSON line: the per-layer metrics of the result line; the window's
device idle time split by the span open over it (``LABELS``: the first of the
cell's list that is open on any thread; in a search cell the lock holder's
work comes first, so that a gap under it is charged to it and not to the
requests waiting); each span's summed time and count in the window; the
device's copies inside ``serve.search`` and ``embed.device`` (the
descriptors' round trip through the host); the device idle time under
Python's garbage collections (timed by a ``gc`` callback), in all and where
no span was open; and whether the trace reader shifted the device's clock
(it must not). The whole record goes to
``chiprun_out/trace_split_<cell>_<seed>.json``.

``one`` runs the cell untraced, as the benchmark's end-to-end runs do, with
the event log's recording forced on (``--record on``) or left off; its last
line is the benchmark's result line. Forced on, torch's profiler flag is set
with no profile running and the main thread is taken for the one that the
profiler follows, as in a traced run: every span and counter appends its
event, the main thread's spans open their ``record_function`` ranges, and
nothing else is profiled. Run the two in turns (off, on, on, off) in one
call to read what recording costs each cell."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LABELS = {
    "search": ("embed.device", "embed.prep", "serve.embed", "serve.search", "serve.upload",
               "decode.pixels", "decode.entropy", "serve.decode", "serve.read",
               "serve.respond", "serve.lock_wait"),
    "train": ("scalar_fetch", "metrics_write", "segment_sync", "host_build", "dispatch_put",
              "train_step", "pca_update", "pool_build", "epoch_setup", "ckpt_save", "eval_loss",
              "eval_localization", "mining_refresh", "mining_refresh_async"),
}


def idle_split(gaps, spans, labels) -> dict:
    """Seconds of the gaps under each label: the first of ``labels`` with a
    span open, else ``other span`` (a span not in the list) or ``no span
    open``."""
    edges = []
    for name, _, s, e, _ in spans:
        edges.append((s, 1, name))
        edges.append((e, -1, name))
    for s, e in gaps:
        edges.append((s, 2, None))
        edges.append((e, -2, None))
    edges.sort(key=lambda x: (x[0], x[1]))
    open_names: Counter = Counter()
    in_gap = 0
    out: Counter = Counter()
    at = None
    for t, kind, name in edges:
        if at is not None and t > at and in_gap:
            label = next((n for n in labels if open_names[n] > 0), None)
            if label is None:
                label = "other span" if +open_names else "no span open"
            out[label] += (t - at) / 1e9
        at = t
        if kind == 1:
            open_names[name] += 1
        elif kind == -1:
            open_names[name] -= 1
        else:
            in_gap += 1 if kind == 2 else -1
    return dict(out.most_common())


def unattributed(gaps, spans, n: int = 12) -> list:
    """The ``n`` longest stretches of idle time under no span, each with the
    span that ended last before it and the one that started first after it:
    [seconds, before, after]."""
    from bisect import bisect_left, bisect_right

    from benchmarks.metrics._trace import union_length

    _, covered = union_length((s, e) for _, _, s, e, _ in spans)
    free, j = [], 0
    for s, e in gaps:
        at = s
        while j < len(covered) and covered[j][1] <= s:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < e:
            if covered[k][0] > at:
                free.append((at, covered[k][0]))
            at = max(at, covered[k][1])
            k += 1
        if at < e:
            free.append((at, e))
    ends = sorted((e, n) for n, _, _, e, _ in spans)
    starts = sorted((s, n) for n, _, s, _, _ in spans)
    out = []
    for s, e in sorted(free, key=lambda f: f[0] - f[1])[:n]:
        i = bisect_right(ends, (s, chr(0x10FFFF))) - 1
        k = bisect_left(starts, (e, ""))
        out.append([(e - s) / 1e9, ends[i][1] if i >= 0 else None,
                    starts[k][1] if k < len(starts) else None])
    return out


def _intersect(a, b) -> list:
    """The intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def copies_inside(trace, spans, names) -> dict:
    """The device's copies (by name) that overlap a span of ``names``:
    {span name: {copy name: [count, seconds]}}."""
    out = {}
    for target in names:
        windows = sorted((s, e) for n, _, s, e, _ in spans if n == target)
        found: dict = {}
        copies = sorted((s, e, n) for n, s, e, c in trace.ops if c == "gpu_memcpy")
        j = 0
        for s, e, n in copies:
            while j < len(windows) and windows[j][1] < s:
                j += 1
            if j < len(windows) and windows[j][0] <= e:
                entry = found.setdefault(n, [0, 0.0])
                entry[0] += 1
                entry[1] += (e - s) / 1e9
        out[target] = found
    return out


def split(args) -> int:
    import torch

    from benchmarks import run
    from benchmarks.harness import Cell, process_start_s
    from benchmarks.metrics import _trace
    from benchmarks.metrics._spans import overlap_ns, window_events

    shifted = []
    from_chrome = _trace.DeviceTrace.from_chrome.__func__

    def checked(cls, trace, start_ns, end_ns):
        base = int(trace.get("baseTimeNanoseconds", 0))
        ops = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
               and str(e.get("cat", "")).lower() in _trace.DEVICE_CATS]
        inside = sum(1 for e in ops if start_ns < base + float(e["ts"]) * 1e3 < end_ns)
        shifted.append({"ops": len(ops), "inside": inside, "shifted": inside < len(ops) / 2})
        return from_chrome(cls, trace, start_ns, end_ns)

    _trace.DeviceTrace.from_chrome = classmethod(checked)
    from soft_contrastive_learning_torch.core.logging import EVENTS

    collections, at = [], {}

    def on_gc(phase, info):
        now = time.perf_counter_ns() + EVENTS.offset_ns
        if phase == "start":
            at["t"] = now
        elif "t" in at:
            collections.append((at.pop("t"), now))

    gc.callbacks.append(on_gc)
    started = process_start_s()
    bench = run.load_json(REPO / "BENCHMARK.json")
    workload = run.find_workload(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run.set_cache_dirs(run.ROOT / "_work")
    work = run.ROOT / "_work" / args.workload
    work.mkdir(parents=True, exist_ok=True)
    cell = Cell(name=args.workload, config=run.find_config(workload["config"]),
                params=workload["params"], seed=args.seed, seconds=args.seconds, trace=True,
                device=device, work_dir=work, started=started)
    outcome = run.find_traffic(workload["kind"]).run(cell)
    line = run.result_line(outcome, run.cell_metrics(bench, args.workload, True), True,
                           {"platform": "gpu"}, args.workload)
    trace = outcome.trace
    ev = window_events(outcome.readings)
    kind = outcome.readings["kind"]
    spans = ev.spans if ev is not None else []
    totals: dict = {}
    for name, _, s, e, _ in spans:
        entry = totals.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) / 1e9
    record = {
        "workload": args.workload, "seed": args.seed, "correct": line["correct"],
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "window_s": trace.window_s, "busy_s": trace.busy_s(),
        "idle_s": sum(e - s for s, e in trace.gaps()) / 1e9,
        "idle_split_s": idle_split(trace.gaps(), spans, LABELS[kind]),
        "unattributed": unattributed(trace.gaps(), spans),
        "span_totals": {k: {"count": v[0], "total_s": v[1]}
                        for k, v in sorted(totals.items(), key=lambda kv: -kv[1][1])},
        "counts": {n: ev.count(n) for n in sorted({c[0] for c in ev.counts})} if ev else {},
        "steps": outcome.readings.get("steps"), "served": outcome.readings.get("served"),
        "clock": shifted,
        "breakdown": line.get("breakdown"),
    }
    gaps = trace.gaps()
    _, covered = _trace.union_length((s, e) for _, _, s, e, _ in spans)
    _, under_gc = _trace.union_length(c for c in collections
                                      if c[1] > trace.start_ns and c[0] < trace.end_ns)
    record["gc"] = {
        "collections": len(under_gc), "total_s": sum(b - a for a, b in under_gc) / 1e9,
        "idle_s": overlap_ns(gaps, under_gc) / 1e9,
        "idle_no_span_s": (overlap_ns(gaps, under_gc)
                           - overlap_ns(gaps, _intersect(covered, under_gc))) / 1e9}
    if kind == "search":
        record["copies"] = copies_inside(trace, spans, ("serve.search", "embed.device"))
    out = REPO / "chiprun_out" / f"trace_split_{args.workload}_{args.seed}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({k: v for k, v in record.items() if k not in ("breakdown",)}))
    return 0 if line["correct"] else 1


def one(args) -> int:
    if args.record == "on":
        import threading

        import torch.autograd.profiler as profiler
        from torch._C import _autograd

        profiler._is_profiler_enabled = True
        _autograd._profiler_enabled = lambda: threading.current_thread() is threading.main_thread()
    from benchmarks import run

    return run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                     str(args.seconds), "--trace", "0"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("split", "one"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--record", choices=("on", "off"), default="off")
    args = ap.parse_args(argv)
    return split(args) if args.mode == "split" else one(args)


if __name__ == "__main__":
    sys.exit(main())
