"""device_idle.batch: share of the profiler window in which no
operation ran on the card, %."""

from benchmark.harness import readers


def read(layer):
    return readers.idle_pct(layer, "batch")
