"""Share of the rows that the extractor runs through the model that are
padding (its counters in the traced window: ``embed.padded`` over
``embed.images`` + ``embed.padded``), in %."""

from benchmarks.metrics._spans import window_events


def read(name, r):
    ev = window_events(r)
    if ev is None:
        return None
    padded = ev.count("embed.padded")
    rows = ev.count("embed.images") + padded
    return 100.0 * padded / rows if rows else None
