"""tick_host_ms.stream: a tick's latency as the window times it (the
attaches and detaches of the sessions that start, every slot's submit,
step()), minus the tick's enhance_chunk span, ms: the serve layer's own
host work around the program's call."""

from benchmark.harness import readers


def read(layer):
    tick = readers.span_ms(layer, "tick", "stream")
    call = readers.span_ms(layer, "enhance_chunk", "stream")
    return None if tick is None or call is None else tick - call
