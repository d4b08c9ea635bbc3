"""K2's share of its roofline: the bound time of one search (its queries,
the index, k) over its device time per search (the three kernels of a
call, from the trace), in %."""

from benchmarks.roofline import k2_bound_s


def read(name, r):
    trace = r.get("trace")
    if r.get("kind") != "search" or trace is None:
        return None
    k2 = trace.by_id().get("K2.calls")
    if not k2 or not k2["launches"]:
        return None
    rows, dim = r["index_shape"]
    bound = k2_bound_s(r["images_per_request"], rows, dim, r["k"])
    return 100.0 * bound / (k2["seconds"] / k2["launches"])
