"""K3's share of its roofline: the launches' bound time at the cell's batch
and descriptor width over their device time, in %."""

from benchmarks.roofline import k3_bound_s


def read(name, r):
    trace = r.get("trace")
    if trace is None:
        return None
    k3 = trace.by_id().get("K3")
    if not k3 or not k3["seconds"]:
        return None
    model = r["config"]["model"]
    dim = model.get("vlad_cores", 64) * 512
    return 100.0 * k3["launches"] * k3_bound_s(r["batch"], dim) / k3["seconds"]
