"""Share of the extractor's batches in the traced window that ran as a
replay of its captured CUDA graph, in %: ``embed.graph_replays`` times the
batch size over the rows the model ran (``embed.images`` +
``embed.padded``). The extractor counts ``embed.graph_replays`` on every
batch, 0 for an eager one; a program that never counts it has no graph
path, and there is nothing to read."""

from benchmarks.metrics._spans import window_events


def read(name, r):
    ev = window_events(r)
    if ev is None or not any(c[0] == "embed.graph_replays" for c in ev.counts):
        return None
    rows = ev.count("embed.images") + ev.count("embed.padded")
    if not rows:
        return None
    return 100.0 * ev.count("embed.graph_replays") * r["config"]["batch_size"] / rows
