"""The stream loop's traced ticks are the window's kind of tick: after
the window they run through the same drive(), on the schedule's next
ticks, so every slot submits a real frame and the sessions that start
there attach.  The "tick" span is drive()'s latency.  On the CPU at a
tiny size, with the profiler session stood in for."""

import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import run as brun
from benchmark.harness import program, traffic
from benchmark.tests import bench_tiny


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.make(pathlib.Path(tmp_path_factory.mktemp("bench")))


def test_traced_ticks_submit_real_frames_and_attach(tiny, monkeypatch):
    from percepnet_tpu_torch import serve
    bench, bench_dir = tiny
    loop = brun.load_loop("stream", bench_dir)
    seen = {"submit": [], "attach": 0}
    orig_submit, orig_attach = serve.StreamingServer.submit, \
        serve.StreamingServer.attach

    def submit(self, sid, frame):
        seen["submit"].append(np.asarray(frame).copy())
        return orig_submit(self, sid, frame)

    def attach(self):
        seen["attach"] += 1
        return orig_attach(self)

    monkeypatch.setattr(serve.StreamingServer, "submit", submit)
    monkeypatch.setattr(serve.StreamingServer, "attach", attach)
    profiled = []

    def profile(self, fn, calls):
        for _ in range(2):                   # trace.summary runs fn twice
            n = len(seen["submit"])
            fn()
            profiled.append(len(seen["submit"]) - n)
        return {"calls": calls, "wall_s": 1.0, "busy_s": 0.5}

    monkeypatch.setattr(brun.Context, "profile", profile)
    mix = bench_tiny.TINY_STREAM
    cfg = program.load_config(bench_dir, "percepnet-bf16-log1p")
    ctx = brun.Context("tiny-bf16-stream", cfg, mix, 3, 0.3, True,
                       torch.device("cpu"), bench_tiny.REPO,
                       time.perf_counter())
    res = loop.run(ctx)
    slots, ticks = mix["slots"], 30
    spans = res["layer"]["spans"]
    assert len(spans["tick"]) == loop.SPAN_TICKS
    assert len(spans["enhance_chunk"]) == loop.SPAN_TICKS
    assert all(a >= b for a, b in zip(spans["tick"],
                                      spans["enhance_chunk"]))
    assert profiled == [loop.TRACE_TICKS * slots] * 2
    total = loop.WARMUP_TICKS + ticks + loop.EXTRA_TICKS
    assert len(seen["submit"]) == total * slots
    # the traced ticks carried the schedule's own frames, not silence
    sched = traffic.StreamSchedule(mix, 3, slots, ticks + loop.EXTRA_TICKS,
                                   True, torch.device("cpu"))
    after = np.stack(seen["submit"][(loop.WARMUP_TICKS + ticks) * slots:])
    want = sched.audio[:, ticks * 480:].reshape(slots, -1, 480) \
        .transpose(1, 0, 2).reshape(-1, 480)
    assert np.array_equal(after, want)
    assert np.abs(after).max() > 0
    starts = sum(ticks <= s.start for s in sched.sessions)
    assert starts > 0
    # the warm-up's and the window's attaches, then the later sessions'
    window_starts = sum(0 < s.start < ticks for s in sched.sessions)
    assert seen["attach"] == 2 * slots + window_starts + starts
    assert res["numbers"]["pcm_gap"] is not None
