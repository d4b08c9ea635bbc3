"""Device idle time of the traced training window in which the training
thread (the thread of the ``train_step`` spans) was inside a span of the
step loop (``host_build``, ``dispatch_put``, ``train_step``, ``pca_update``,
``scalar_fetch``), per step of the window, in ms."""

from benchmarks.metrics._spans import window_events

LOOP_SPANS = ("host_build", "dispatch_put", "train_step", "pca_update", "scalar_fetch")


def read(name, r):
    ev = window_events(r) if r.get("kind") == "train" and r.get("steps") else None
    if ev is None:
        return None
    threads = {tid for n, tid, _, _, _ in ev.spans if n == "train_step"}
    if not threads:
        return None
    loop = [sp for sp in ev.spans if sp[0] in LOOP_SPANS and sp[1] in threads]
    return ev.idle_covered_s(loop) * 1e3 / r["steps"]
