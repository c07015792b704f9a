"""What the per-layer metric readers (benchmark/metrics/<name>.py) share.

Each reader gets the traced run's `layer` record: the loop's kind
("batch" or "stream"), its window (calls or ticks, seconds, frame
latencies), the stage spans ("frontend", "model", "synthesis",
"enhance_chunk", and "tick" for the stream), and the profiler window's
summary ("trace": calls, wall_s, busy_s, kernels, events, and "counts",
the launches the program counted for each comb kernel entry).
A reader that finds nothing to read returns None, and the metric is left
out of the line.
"""

from __future__ import annotations

import statistics

from benchmark.harness import flops

B1_KERNEL = "comb_tile_kernel"


def span_ms(layer: dict, stage: str, kind: str) -> float | None:
    """The stage's mean span per call or tick, ms."""
    if layer.get("kind") != kind:
        return None
    v = layer.get("spans", {}).get(stage)
    return statistics.fmean(v) if v else None


def idle_pct(layer: dict, kind: str) -> float | None:
    """Share of the profiler window with nothing running on the card."""
    t = layer.get("trace")
    if layer.get("kind") != kind or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])


def launches_per_call(layer: dict, kind: str) -> float | None:
    t = layer.get("trace")
    if layer.get("kind") != kind or not t or not t["kernels"]:
        return None
    return t["kernels"] / t["calls"]


def b1_roofline(layer: dict) -> float | None:
    """B1's least time for the bytes it must move (flops.comb_bytes) at
    3.35 TB/s over its time on the card, %; only where the program
    counted B1 launches and the trace holds its kernels."""
    t = layer.get("trace")
    if layer.get("kind") != "batch" or not t:
        return None
    launched = sum(n for k, n in t.get("counts", {}).items()
                   if k.startswith("windows_"))
    ns = sum(e - s for s, e, name in t["events"] if B1_KERNEL in name)
    if launched == 0 or ns == 0:
        return None
    need = launched * flops.comb_bytes(layer["streams"], layer["frames"],
                                       layer["precision"]["comb_store"])
    return 100.0 * need / flops.HBM_BYTES_PER_S / (ns / 1e9)


def mfu(layer: dict) -> float | None:
    """The call's least time at the configured peaks over its host
    seconds in the window, %."""
    if layer.get("kind") != "batch" or not layer.get("calls"):
        return None
    per_call = layer["window_s"] / layer["calls"]
    ideal = flops.ideal_seconds(layer["streams"], layer["frames"],
                                layer["precision"])
    return 100.0 * ideal / per_call
