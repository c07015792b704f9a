"""A run with the timed path broken underneath sees `correct` come out
false, once for each fault the cells can have, and a sound run sees it
true.  The run is the harness's own (batch and stream loops, capture,
reference, judge) on the CPU at a tiny size, held to the real cells'
limits; only the look for a card is skipped.  The cells run on one
card, so there is no exchange between cards to leave out."""

import pathlib

import pytest
import torch

from benchmark.tests import bench_tiny

FAULTS = ("none", "state_unchanged", "half_batch", "answer_altered")
CELLS = ("tiny-f32-batch", "tiny-bf16-stream")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.make(pathlib.Path(tmp_path_factory.mktemp("bench")))


# the call whose answer is altered: the window's first call after the
# one warm-up call, or the window's tenth tick after the 20 warm-up ticks
ALTERED_CALL = {"tiny-f32-batch": 2, "tiny-bf16-stream": 30}


def _break(monkeypatch, fault: str, altered_call: int):
    from percepnet_tpu_torch import pipeline
    orig = pipeline.enhance_chunk
    calls = [0]

    def broken(model, signal, state, *args, **kwargs):
        pcm, new_state, *rest = orig(model, signal, state, *args, **kwargs)
        calls[0] += 1
        if fault == "state_unchanged":
            new_state = state
        elif fault == "half_batch":
            # the second half of the streams never computed
            pcm = pcm.clone()
            pcm[pcm.shape[0] // 2:] = 0.0
        elif fault == "answer_altered" and calls[0] == altered_call:
            # one frame of every stream altered where it is produced
            pcm = pcm.clone()
            pcm[:, -480:] = 0.05 - pcm[:, -480:]
        return (pcm, new_state, *rest)

    monkeypatch.setattr(pipeline, "enhance_chunk", broken)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(tiny, monkeypatch, cell, fault):
    bench, bench_dir = tiny
    if fault != "none":
        _break(monkeypatch, fault, ALTERED_CALL[cell])
    # stream: 50 ticks; batch: at least one call after the warm-up
    out = bench_tiny.run(cell, bench, bench_dir, seed=5, seconds=0.5)
    assert out["correct"] is (fault == "none"), out["compared"]


def test_the_sample_reaches_the_broken_half(tiny):
    """The seed above samples streams and sessions from both halves, so
    that leaving out half of the batch is seen."""
    from benchmark.harness import traffic
    rows = traffic.sample_rows(bench_tiny.TINY_BATCH["streams"],
                               bench_tiny.TINY_BATCH["sample_streams"], 5)
    assert max(rows) >= bench_tiny.TINY_BATCH["streams"] // 2
    sched = traffic.StreamSchedule(bench_tiny.TINY_STREAM, 5, 4, 50, True,
                                   torch.device("cpu"))
    picked = traffic.sample_sessions(sched, 4, 5)
    assert max(s.slot for s in picked) >= 2
