"""The batch loop: offline enhancement of long files, closed loop, as a
batch job runs.  Back-to-back pipeline.enhance_chunk calls of
mix["streams"] x mix["frames_per_call"] frames, state carried from call
to call, for the window's seconds.

End to end: audio_s_per_s, the audio enhanced over the whole window's
wall time (all calls, from the first call's start to a synchronize after
the last; at least MIN_CALLS calls).  `correct`: the sampled streams'
periods, features, comb band energies, g, r and PCM of the window's
first two thirds of calls, against the reference run over those
streams' signal from the window's start.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from benchmark.harness import judge, program, traffic
from benchmark.harness.probe import Probe
from benchmark.reference import percepnet_ref as R

FRAME = 480
SPAN_CALLS = 3                   # calls timed stage by stage when traced
# The reference costs about what the program does per frame (both are
# launch-bound loops over frames), so it follows the sampled streams
# through the first two thirds of the window's calls: shorter than the
# window.
CHECK_SHARE = 2 / 3
TRACE_CALLS = 1                  # calls under the profiler when traced
# the window makes at least this many calls, however slow the host, so
# that the check follows the state carried from call to call
MIN_CALLS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    from percepnet_tpu_torch import pipeline
    dev, cfg, mix = ctx.device, ctx.config, ctx.mix
    streams, frames = mix["streams"], mix["frames_per_call"]
    feed = traffic.BatchFeed(mix, ctx.seed, dev)
    flat = program.make_weights(cfg, ctx.seed, dev, ctx.repo)
    model, kw = program.build_model(flat, cfg)
    model_dtype = torch.float32
    if program.bf16(cfg):
        model = model.to(torch.bfloat16)       # the serving copy, cast once
        model_dtype = torch.bfloat16
    rows = torch.as_tensor(traffic.sample_rows(streams, mix["sample_streams"],
                                               ctx.seed), device=dev)
    probe = Probe(dev)
    probe.install(model)
    cap: dict[str, list] = {k: [] for k in
                            ("period", "features", "ep", "g", "r")}

    def capture(stage, out):
        if stage == "frontend":
            front = out[0]
            for k in ("period", "features", "ep"):
                cap[k].append(front[k].index_select(0, rows))
        elif stage == "model":
            cap["g"].append(out[0].index_select(0, rows))
            cap["r"].append(out[1].index_select(0, rows))

    def call(state, k):
        return pipeline.enhance_chunk(model, feed.chunk(k), state,
                                      device=dev, **kw)

    def fresh():
        return pipeline.init_pipeline_state(streams, model_dtype=model_dtype,
                                            device=dev)

    def step(state, k, pcms, bad):
        """One call as the window makes it, with what it keeps."""
        pcm, state = call(state, k)
        pcms.append(pcm.index_select(0, rows))
        bad += (~torch.isfinite(pcm).all(dim=1)).sum()
        return state

    try:
        # warm-up: the window's own calls, capture and checks included,
        # so that nothing runs for the first time inside the window
        probe.capture = capture
        state = fresh()
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(mix["warmup_calls"]):
            state = step(state, k, [], bad)
        _sync(dev)
        for v in cap.values():
            v.clear()
        state = fresh()
        pcms, bad = [], torch.zeros((), dtype=torch.int64, device=dev)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - ctx.t0

        t0 = time.perf_counter()
        stamps = []
        calls = 0
        while True:
            state = step(state, calls, pcms, bad)
            calls += 1
            stamps.append(time.perf_counter())
            if stamps[-1] - t0 >= ctx.seconds and calls >= MIN_CALLS:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
        per_call = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
        med = sorted(per_call)[len(per_call) // 2]
        slow = [(i, round(ms)) for i, ms in enumerate(per_call)
                if ms > 2 * med]
        print(f"window: {calls} calls in {window_s:.3f} s; host ms per "
              f"call min {min(per_call):.1f}, median {med:.1f}, max "
              f"{max(per_call):.1f}; over twice the median (call, ms): "
              f"{slow}", file=sys.stderr)
        probe.capture = None
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        layer = {"kind": "batch", "calls": calls, "window_s": window_s,
                 "streams": streams, "frames": frames,
                 "precision": cfg["precision"]}
        if ctx.trace:
            probe.spans = True
            for k in range(calls, calls + SPAN_CALLS):
                _, state = call(state, k)
            probe.spans = False
            layer["spans"] = {k: v for k, v in probe.span_ms.items()}
            probe.ranges = True
            layer["trace"] = ctx.profile(
                lambda: call(state, calls + SPAN_CALLS), TRACE_CALLS)
            probe.ranges = False
        failed = int(bad)
        del state, model
    finally:
        probe.uninstall()

    # the reference, after the window and the program's state are gone
    checked = max(1, math.ceil(CHECK_SHARE * calls))
    signal = feed.signal(rows, checked)
    t_ref = time.perf_counter()
    ref = R.enhance(signal, R.unflatten(flat), R.Precision.from_config(cfg),
                    cfg["features"]["log1p"])
    n = rows.numel()
    prog = {k: torch.cat(v[:checked], dim=1) for k, v in cap.items()
            if len(v) == calls}
    prog["pcm"] = torch.cat(pcms[:checked], dim=1).reshape(
        n, checked * frames, FRAME)
    ref["pcm"] = ref["pcm"].reshape(n, checked * frames, FRAME)
    valid = torch.ones((n, checked * frames), dtype=torch.bool, device=dev)
    nums = judge.numbers(prog, ref, valid)
    nums["reference_s"] = time.perf_counter() - t_ref
    if ctx.control:
        ctl = R.enhance(signal, R.unflatten(flat),
                        R.Precision.from_config(cfg).lower(),
                        cfg["features"]["log1p"])
        ctl["pcm"] = ctl["pcm"].reshape(n, checked * frames, FRAME)
        nums["control"] = judge.numbers(ctl, ref, valid)
    return {"attempted": calls * streams, "failed": failed,
            "end_to_end": {"audio_s_per_s":
                           calls * streams * frames * FRAME / 48_000
                           / window_s, "setup_s": setup_s},
            "memory_peak_bytes": peak, "layer": layer, "numbers": nums}
