"""Share of the traced window's device idle time (the trace's gaps) in which
no span of the program was open on any thread, in %."""

from benchmarks.metrics._spans import window_events


def read(name, r):
    ev = window_events(r)
    if ev is None or not ev.spans:
        return None
    idle = ev.idle_s()
    return 100.0 * (idle - ev.idle_covered_s()) / idle if idle > 0 else 0.0
