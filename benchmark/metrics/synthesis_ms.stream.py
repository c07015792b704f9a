"""synthesis_ms.stream: the synthesis stage's span per tick, ms (host clock
between synchronizes, around the program's call into the layer)."""

from benchmark.harness import readers


def read(layer):
    return readers.span_ms(layer, "synthesis", "stream")
