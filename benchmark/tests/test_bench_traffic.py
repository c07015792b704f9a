"""Both mixes are a function of the seed: the same seed gives the same
inputs, another seed other inputs of the same sizes."""

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.tests import bench_tiny

CPU = torch.device("cpu")
SEEDS = (2**31 + 17, 2**40 + 3)


def test_batch_feed_is_a_function_of_the_seed():
    mix = bench_tiny.TINY_BATCH
    a = traffic.BatchFeed(mix, SEEDS[0], CPU)
    b = traffic.BatchFeed(mix, SEEDS[0], CPU)
    c = traffic.BatchFeed(mix, SEEDS[1], CPU)
    for k in (0, 3):
        x, y, z = a.chunk(k), b.chunk(k), c.chunk(k)
        assert x.shape == z.shape == (mix["streams"],
                                      mix["frames_per_call"] * 480)
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
        # on the int16 grid, speech-like, not silent
        assert torch.equal(x * 32768, torch.round(x * 32768))
        assert float(x.abs().max()) > 0.05
    rows = torch.tensor([1, 3])
    assert torch.equal(a.signal(rows, 2)[:, :a.n], a.chunk(0)[rows])
    assert torch.equal(a.signal(rows, 2)[:, a.n:], a.chunk(1)[rows])
    assert np.array_equal(traffic.sample_rows(512, 16, SEEDS[0]),
                          traffic.sample_rows(512, 16, SEEDS[0]))


def test_stream_schedule_is_a_function_of_the_seed():
    mix = bench_tiny.TINY_STREAM
    a = traffic.StreamSchedule(mix, SEEDS[0], 4, 60, True, CPU)
    b = traffic.StreamSchedule(mix, SEEDS[0], 4, 60, True, CPU)
    c = traffic.StreamSchedule(mix, SEEDS[1], 4, 60, True, CPU)
    assert a.audio.dtype == np.int16 and a.audio.shape == (4, 60 * 480)
    assert np.array_equal(a.audio, b.audio)
    assert a.sessions == b.sessions
    assert c.audio.shape == a.audio.shape
    assert not np.array_equal(a.audio, c.audio)
    # every slot is occupied all the time, sessions back to back
    for slot in range(4):
        mine = [s for s in a.sessions if s.slot == slot]
        assert mine[0].start == 0
        for s, t in zip(mine, mine[1:]):
            assert t.start == s.start + s.frames
        assert mine[-1].start + mine[-1].frames >= 60
    picked = traffic.sample_sessions(a, 3, SEEDS[0])
    assert picked == traffic.sample_sessions(b, 3, SEEDS[0])
    assert max(s.frames for s in a.finished()) == picked[0].frames
    # the float wire carries the same samples at /32768 scale
    f = traffic.StreamSchedule(mix, SEEDS[0], 4, 60, False, CPU)
    assert np.array_equal(f.audio * 32768.0, a.audio.astype(np.float32))
    s = picked[0]
    assert np.array_equal(a.session_input(s), f.session_input(s))


def test_a_burst_attaches_many_sessions_in_one_tick():
    """mix["burst"] ends the sessions of a share of the slots every
    every_s seconds; without it the schedule is as before."""
    plain = traffic.StreamSchedule(bench_tiny.TINY_STREAM, SEEDS[0], 8, 60,
                                   True, CPU)
    mix = dict(bench_tiny.TINY_STREAM, burst={"every_s": 0.2, "share": 0.75})
    a = traffic.StreamSchedule(mix, SEEDS[0], 8, 60, True, CPU)
    assert a.sessions == traffic.StreamSchedule(mix, SEEDS[0], 8, 60, True,
                                                CPU).sessions
    for k in (20, 40):
        assert sum(s.start == k for s in a.sessions) >= 6
    # still every slot occupied all the time, sessions back to back
    for slot in range(8):
        mine = [s for s in a.sessions if s.slot == slot]
        assert mine[0].start == 0 and all(s.frames >= 1 for s in mine)
        for s, t in zip(mine, mine[1:]):
            assert t.start == s.start + s.frames
        assert mine[-1].start + mine[-1].frames >= 60
    nob = dict(bench_tiny.TINY_STREAM, burst=None)
    assert traffic.StreamSchedule(nob, SEEDS[0], 8, 60, True, CPU).sessions \
        == plain.sessions


def test_the_sample_is_of_sessions_that_end_in_the_window():
    a = traffic.StreamSchedule(bench_tiny.TINY_STREAM, SEEDS[0], 4, 80,
                               True, CPU)
    picked = traffic.sample_sessions(a, 4, SEEDS[0], upto=50)
    assert all(s.start + s.frames <= 50 for s in picked)
    assert picked[0].frames == max(s.frames for s in a.finished(50))
