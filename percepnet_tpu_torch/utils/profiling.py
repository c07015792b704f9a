"""Device timing on the card, and the card's published peaks for bounds.

The peaks are an H100 SXM's (NVIDIA data sheet, at its 700 W power
limit): a measurement states the card's name and power limit beside them.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12        # device memory rate
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time for work that moves n_bytes and does n_flops f32
    operations: the larger of the two over the peaks, and which bounds."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def time_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median device time of `runs` calls of fn, each between two CUDA
    events.

    A spin kernel (~1 ms) is queued before each start event, so the host
    has enqueued the whole call before the card reaches it: the events
    then time the card's work, not the host's launch path."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
