"""frame_latency_p50_ms.stream: the median frame latency of the window,
from the tick's start to step()'s return, ms."""

import statistics


def read(layer):
    if layer.get("kind") != "stream" or not layer.get("latency_ms"):
        return None
    return statistics.median(layer["latency_ms"])
