"""The whole step's share of the chip's peak, in %. The traffic kind says
which share its cell reads:

* training (``kind`` "train"): the window's model operations (3 forwards
  of each trained image, 1 of each refresh image; recomputation not
  counted) over the window's length times the bf16 peak;
* search at a fixed offered rate (``mfu_per_request``, set by the open
  loop), where a share of the window would not move: the requests' summed
  least device time (K2's bound, and each image's int8 operations at the
  int8 peak) over their summed latencies;
* any other search (a closed loop): the least device time of the requests
  completed in the window, over the window."""

from benchmarks.roofline import PEAK_BF16, PEAK_INT8, forward_flops, int8_ops, k2_bound_s


def _least_s(r) -> float:
    model = r["config"]["model"]
    rows, dim = r["index_shape"]
    m = r["images_per_request"]
    return (k2_bound_s(m, rows, dim, r["k"])
            + m * int8_ops(model["image_height"], model["image_width"]) / PEAK_INT8)


def read(name, r):
    if r.get("kind") == "train":
        model = r["config"]["model"]
        fwd = forward_flops(model["image_height"], model["image_width"], model["vlad_cores"])
        flops = fwd * (3 * r["images"] + r["refresh_images"])
        return 100.0 * flops / (r["window_s"] * PEAK_BF16)
    if r.get("kind") != "search" or not r.get("rows"):
        return None
    least = _least_s(r)
    if r.get("mfu_per_request"):
        latency = sum(row[2] - row[0] for row in r["rows"])
        return 100.0 * least * len(r["rows"]) / latency
    return 100.0 * least * len(r["rows"]) / r["seconds"]
