"""model_ms.stream: the model stage's span per tick, ms (host clock
between synchronizes, around the program's call into the layer)."""

from benchmark.harness import readers


def read(layer):
    return readers.span_ms(layer, "model", "stream")
