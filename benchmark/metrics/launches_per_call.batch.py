"""launches_per_call.batch: kernels on the card per enhance_chunk call in
the profiler window (copies and fills not counted)."""

from benchmark.harness import readers


def read(layer):
    return readers.launches_per_call(layer, "batch")
