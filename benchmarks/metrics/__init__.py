"""Per-layer metric readers: ``<base>.py`` reads every metric named
``<base>`` or ``<base>.<cell family>`` through ``read(name, readings)``,
from the run's host spans, counts and device trace. A reader that finds
nothing to read returns None, and the metric is left out of the line."""
