"""K1's share of its roofline, forward and backward together: the launches'
bound time at the cell's batch over their device time, in %."""

from benchmarks.roofline import conv_maps, k1_backward_bound_s, k1_forward_bound_s


def read(name, r):
    trace = r.get("trace")
    if trace is None:
        return None
    ids = trace.by_id()
    fwd, bwd = ids.get("K1.fwd"), ids.get("K1.bwd")
    seconds = (fwd["seconds"] if fwd else 0.0) + (bwd["seconds"] if bwd else 0.0)
    if not seconds:
        return None
    model = r["config"]["model"]
    h, w = conv_maps(model.get("image_height", 180), model.get("image_width", 240))[-1]
    shape = (r["batch"], h * w, model.get("vlad_cores", 64), 512)
    bound = ((fwd["launches"] if fwd else 0) * k1_forward_bound_s(*shape)
             + (bwd["launches"] if bwd else 0) * k1_backward_bound_s(*shape))
    return 100.0 * bound / seconds
