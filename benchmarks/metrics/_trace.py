"""One traced window of the device, read from ``torch.profiler``'s chrome
trace: the device operations' intervals (kernels, copies, sets), their
union (the
device's busy time), the kernels by ``PERF.md``'s ids, and the ``breakdown``
of the result line: the operations that took most time and the longest
idle gaps, each labelled with the host span that was open at the gap's
middle."""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# (id, substrings of the kernel's name); Q1's stem is told apart by its STEM argument
KERNEL_IDS = (
    ("K2", ("topk_partial_kernel", "topk_merge_kernel", "split_queries_kernel")),
    ("K1", ("netvlad_forward_kernel", "netvlad_backward_kernel", "center_grad_kernel")),
    ("K3", ("wms_kernel",)),
    ("J1", ("j1_kernel",)),
    ("Q1_pool", ("pool_kernel",)),
    ("K4", ("winograd_kernel",)),
    ("Q1", ("conv_kernel",)),
)
_CONV_ARGS = re.compile(r"conv_kernel<([^>]*)>")


def kernel_id(name: str) -> Optional[str]:
    """The ``PERF.md`` id of a hand-written kernel's name, or None."""
    for kid, parts in KERNEL_IDS:
        if any(p in name for p in parts):
            if kid == "Q1":
                m = _CONV_ARGS.search(name)
                args = [a.strip() for a in m.group(1).split(",")] if m else []
                if len(args) > 4 and args[4] not in ("0", "(int)0"):
                    return "Q1_stem"
            return kid
    return None


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameter list."""
    base = name.replace("(anonymous namespace)::", "")
    while re.search(r"<[^<>]*>", base):
        base = re.sub(r"<[^<>]*>", "", base)
    base = base.split("(", 1)[0].replace("void ", "").strip()
    return base[:80]


def union_length(intervals: Iterable[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, merged intervals) of half-open intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


class DeviceTrace:
    """Device operations as (name, start_ns, end_ns, category) on the host's
    wall clock, clipped to the window [start_ns, end_ns]."""

    def __init__(self, ops: Sequence[Tuple[str, int, int, str]], start_ns: int, end_ns: int):
        self.start_ns, self.end_ns = start_ns, end_ns
        self.ops = [(n, max(s, start_ns), min(e, end_ns), c) for n, s, e, c in ops
                    if e > start_ns and s < end_ns]

    @classmethod
    def from_chrome(cls, trace: dict, start_ns: int, end_ns: int) -> "DeviceTrace":
        """From a chrome trace (``export_chrome_trace``): the complete events
        whose category is a kernel, a copy or a set; runtime calls, host
        operators and annotations are left out. Timestamps are microseconds
        after ``baseTimeNanoseconds`` where the trace gives it, else after
        the epoch; where most operations fall outside the window, another
        clock is taken to have been used, and the window's first operation
        to start with it."""
        base = int(trace.get("baseTimeNanoseconds", 0))
        ops = []
        for ev in trace.get("traceEvents", []):
            cat = str(ev.get("cat", "")).lower()
            if ev.get("ph") != "X" or cat not in DEVICE_CATS:
                continue
            s = base + int(round(float(ev["ts"]) * 1000.0))
            ops.append((ev.get("name", "?"), s, s + int(round(float(ev.get("dur", 0)) * 1000.0)),
                        cat))
        inside = sum(1 for _, s, e, _ in ops if e > start_ns and s < end_ns)
        if ops and inside < len(ops) / 2:
            shift = start_ns - min(s for _, s, _, _ in ops)
            ops = [(n, s + shift, e + shift, c) for n, s, e, c in ops]
        return cls(ops, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e, _ in self.ops)[0] / 1e9

    def idle_share(self) -> Optional[float]:
        if not self.ops or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s() / self.window_s

    def kernel_s(self) -> float:
        """Summed time of the kernels (not copies or sets)."""
        return sum(e - s for _, s, e, c in self.ops if c == "kernel") / 1e9

    def by_id(self) -> Dict[str, Dict[str, float]]:
        """{id: {"launches": n, "seconds": t}} of the hand-written kernels;
        K1 also as ``K1.fwd`` and ``K1.bwd`` (the backward kernel's launches,
        the time of it and of the center gradient), and ``K2.calls`` (the
        searches: the merge kernel's launches, the time of all three)."""
        out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"launches": 0, "seconds": 0.0})
        for name, s, e, cat in self.ops:
            kid = kernel_id(name) if cat == "kernel" else None
            if kid is None:
                continue
            # (key, counts a call): K1.fwd / K1.bwd split K1; a K2 call ends in its merge
            keys = [(kid, True)]
            if kid == "K1":
                keys.append(("K1.fwd", True) if "forward" in name
                            else ("K1.bwd", "netvlad_backward" in name))
            if kid == "K2":
                keys.append(("K2.calls", "merge" in name))
            for key, call in keys:
                out[key]["launches"] += int(call)
                out[key]["seconds"] += (e - s) / 1e9
        return dict(out)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Counter = Counter()
        for name, s, e, _ in self.ops:
            kid = kernel_id(name)
            total[f"{kid}: {short_name(name)}" if kid else short_name(name)] += (e - s) / 1e9
        return [[k, v] for k, v in total.most_common(n)]

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals of the window, between and around the busy ones."""
        _, merged = union_length((s, e) for _, s, e, _ in self.ops)
        out, at = [], self.start_ns
        for s, e in merged:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end_ns > at:
            out.append((at, self.end_ns))
        return out

    def longest_gaps(self, spans: Sequence[Tuple[str, int, int]], n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps, each named by the host spans open at
        its middle (innermost first), or ``no span open`` where none is (in a
        search cell: no request in the service)."""
        out = []
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) // 2
            open_spans = sorted((sp for sp in spans if sp[1] <= mid <= sp[2]),
                                key=lambda sp: sp[2] - sp[1])
            label = "+".join(dict.fromkeys(sp[0] for sp in open_spans)) or "no span open"
            out.append([label, (e - s) / 1e9])
        return out

    def breakdown(self, spans: Sequence[Tuple[str, int, int]] = ()) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.longest_gaps(spans)}


class DeviceProfiler:
    """``torch.profiler`` over one window, device activity only: entered at
    the window's start and left at its end; ``trace`` is then the window's
    ``DeviceTrace``, read from the profiler's chrome trace (a temporary
    file, deleted once read)."""

    def __init__(self):
        self.trace: Optional[DeviceTrace] = None
        self._prof = None
        self._start_ns = 0

    def __enter__(self):
        import time

        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        import time

        import torch

        torch.cuda.synchronize()
        end_ns = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = DeviceTrace.from_chrome(self._chrome(), self._start_ns, end_ns)

    def _chrome(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.unlink(path)
