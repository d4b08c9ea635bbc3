"""Mean time a request waited for the service's lock: the program's
``serve.lock_wait`` spans in the traced window (the embed's and the
search's waits), summed, per request served (``serve.requests``), in ms."""

from benchmarks.metrics._spans import window_events


def read(name, r):
    ev = window_events(r) if r.get("kind") == "search" else None
    served = ev.count("serve.requests") if ev is not None else 0
    if not served:
        return None
    return ev.total_s(("serve.lock_wait",)) * 1e3 / served
