"""Summed kernel time of the traced training window per step, in ms."""


def read(name, r):
    trace = r.get("trace")
    if r.get("kind") != "train" or trace is None or not r.get("steps"):
        return None
    return trace.kernel_s() * 1e3 / r["steps"]
