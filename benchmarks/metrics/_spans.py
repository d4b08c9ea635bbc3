"""The program's own spans and counts of a traced window, read from its
event log (``core/logging.py::EVENTS``: Unix nanoseconds, the clock of the
device trace), and the device's idle time under them. Where the program
keeps no such log, or the run was not traced, there is nothing to read."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from benchmarks.metrics._trace import union_length


class WindowEvents:
    """The spans (name, thread, start, end, request) that overlap the
    traced window, clipped to it, and the counts (name, thread, time, n,
    request) taken inside it."""

    def __init__(self, trace, spans: Sequence[tuple], counts: Sequence[tuple]):
        self.trace = trace
        lo, hi = trace.start_ns, trace.end_ns
        self.spans = [(n, tid, max(s, lo), min(e, hi), rid) for n, tid, s, e, rid in spans
                      if e > lo and s < hi]
        self.counts = [c for c in counts if lo <= c[2] <= hi]

    def total_s(self, names: Iterable[str]) -> float:
        names = set(names)
        return sum(e - s for n, _, s, e, _ in self.spans if n in names) / 1e9

    def count(self, name: str) -> int:
        return sum(c[3] for c in self.counts if c[0] == name)

    def idle_covered_s(self, spans: Optional[Sequence[tuple]] = None) -> float:
        """The device's idle time in the window during which at least one of
        ``spans`` (default: every span) was open, in seconds."""
        spans = self.spans if spans is None else spans
        _, merged = union_length((s, e) for _, _, s, e, _ in spans)
        return overlap_ns(self.trace.gaps(), merged) / 1e9

    def idle_s(self) -> float:
        return sum(e - s for s, e in self.trace.gaps()) / 1e9


def overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def window_events(r) -> Optional[WindowEvents]:
    """The traced window's events, or None: no trace, no event log in the
    program, or no event in the window."""
    trace = r.get("trace")
    if trace is None:
        return None
    try:
        from soft_contrastive_learning_torch.core.logging import EVENTS
    except ImportError:
        return None
    ev = WindowEvents(trace, EVENTS.spans(trace.start_ns, trace.end_ns),
                      EVENTS.counts(trace.start_ns, trace.end_ns))
    return ev if ev.spans or ev.counts else None
