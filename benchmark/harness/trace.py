"""A bounded profiler window on the card, and what is read from it.

torch.profiler can drop kernels on an H100, most in a process that has
run for a while: a session's first kernel, or whole stretches.  So, as
the program's own stage profiler does (a frozen copy of its logic), the
session starts with a kernel of its own, the traced work runs between two
marker kernels (torch.cuda._sleep's spin_kernel), the host idles a margin
before the session stops, and a session that lost a marker runs again
with four times the margin.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

MARKER = "spin_kernel"
MARGIN_S = 0.05
TRIES = 4
NOT_KERNELS = ("Memcpy", "Memset")
NAME_CHARS = 160                 # a breakdown entry's name is cut there


def _events(prof):
    """(device events, host events) of a finished session, each a list of
    (start_ns, end_ns, name) sorted by start.  Read from the raw results,
    without building the host's event tree."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            # a record_function range, which the profiler also mirrors
            # onto the card's timeline: not an operation on the card
            if e.device_type() == DeviceType.CPU:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                             e.name()))
            continue
        item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    dev.sort()
    host.sort()
    return dev, host


def traced(fn, device: torch.device, host: bool) -> dict:
    """Run fn() once under torch.profiler between marker kernels,
    recording the card's activity and, when `host`, the host's operators
    too (which slows the host).  Returns {"wall_s": host seconds of fn
    between two synchronizes, "device": [(start, end, name)] of the
    card's events between the markers, "host": host events}.  Raises if
    every session lost a marker."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    margin = MARGIN_S
    for _ in range(TRIES):
        with profile(activities=activities) as prof:
            torch.ones(1, device=device).add_(1)
            torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            time.sleep(margin)
        dev, host = _events(prof)
        marks = [i for i, e in enumerate(dev) if MARKER in e[2]]
        if len(marks) == 2:
            return {"wall_s": wall, "device": dev[marks[0] + 1 : marks[1]],
                    "host": host}
        margin *= 4
    raise RuntimeError(f"the profiler lost a marker kernel in {TRIES} "
                       f"sessions")


def busy_intervals(device_events) -> list[tuple[int, int]]:
    """The union of the card's event intervals, in order."""
    out: list[list[int]] = []
    for s, e, _ in device_events:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kernels(device_events) -> int:
    return sum(not name.startswith(NOT_KERNELS)
               for _, _, name in device_events)


def top_ops(device_events, n: int = 10) -> list[list]:
    """The n device operations that took most time: [name, seconds]."""
    tot: dict[str, int] = defaultdict(int)
    for s, e, name in device_events:
        tot[name] += e - s
    return [[k[:NAME_CHARS], v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device_events, host_events, n: int = 10) -> list[list]:
    """Idle time on the card between its operations, summed by what the
    host was doing at each gap's midpoint ("<stage>/<innermost host op>",
    the stage being the innermost bench:* range, "python" where no
    operator was running): the n largest sums, [name, seconds]."""
    busy = busy_intervals(device_events)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]
    gaps.sort(key=lambda g: (g[0] + g[1]) // 2)
    tot: dict[str, int] = defaultdict(int)
    stack: list[tuple[int, int, str]] = []
    stages: list[tuple[int, int, str]] = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host_events) and host_events[i][0] <= mid:
            ev = host_events[i]
            target = stages if ev[2].startswith("bench:") else stack
            target.append(ev)
            i += 1
        for lst in (stack, stages):
            lst[:] = [ev for ev in lst if ev[1] >= mid]
        op = max(stack, key=lambda ev: ev[0])[2] if stack else "python"
        stage = max(stages, key=lambda ev: ev[0])[2][6:] if stages else "-"
        tot[f"{stage}/{op}"] += g1 - g0
    return [[k[:NAME_CHARS], v / 1e9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def summary(fn, device: torch.device, calls: int, counter) -> dict:
    """What the readers take from the profiler, over `calls` calls or
    ticks that fn runs: busy time, kernels and the top operations from a
    window that records the card alone (the host runs at its own speed),
    with what counter() (a dict of the program's counts) gained in it;
    then the idle gaps, named by the host's operators, from a second
    window of as many calls that records both."""
    before = counter()
    t = traced(fn, device, host=False)
    after = counter()
    named = traced(fn, device, host=True)
    busy = sum(e - s for s, e in busy_intervals(t["device"])) / 1e9
    return {"calls": calls, "wall_s": t["wall_s"], "busy_s": busy,
            "counts": {k: after[k] - before[k] for k in before},
            "kernels": kernels(t["device"]),
            "device_ops": top_ops(t["device"]),
            "idle_gaps": idle_gaps(named["device"], named["host"]),
            "events": t["device"]}
