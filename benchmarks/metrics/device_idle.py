"""Share of the traced window in which no device operation ran (the
union of the trace's kernels, copies and sets), in %."""


def read(name, r):
    trace = r.get("trace")
    share = trace.idle_share() if trace is not None else None
    return None if share is None else 100.0 * share
