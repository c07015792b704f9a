"""The stream loop: serving through serve.StreamingServer, closed loop.

Every slot of the server is occupied all the time (traffic.StreamSchedule).
A tick attaches the sessions that start then (each in the slot the
previous one left), submits every slot's frame on the configuration's
wire and calls step().  Ticks run back to back.  The window holds the
frames a real-time window of `seconds` would carry: seconds / frame
period ticks; a frame's latency runs from its tick's start to step()'s
return.  The load sweep (run.py --sweep) drives the same ticks on the
frame clock instead: a tick is due every frame period, a frame's latency
runs from its due time, so a tick that overruns is charged to the frames
behind it.

When traced, the ticks after the window are timed stage by stage
(SPAN_TICKS), then profiled (TRACE_TICKS a profiler session), through
the same drive() as the window, on the schedule's next ticks: real
frames, attaches and detaches.  The "tick" span is drive()'s latency of
a tick.

End to end: frame_latency_p95_ms over every frame of the window (every
slot's frame of a tick shares the tick's latency).  `failed` counts the
frames whose output is missing or not finite.  `correct`: the sampled
finished sessions' periods, features, comb band energies, g, r and PCM
(on the wire, int16 where it is int16), against the reference run over
each session's whole input.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.harness import judge, program, traffic
from benchmark.harness.probe import Probe
from benchmark.reference import percepnet_ref as R

FRAME = 480
SPAN_TICKS = 100                 # ticks timed stage by stage when traced
TRACE_TICKS = 20                 # ticks under the profiler when traced
WARMUP_TICKS = 20
# rendered after the window in every run, traced or not, so that the
# window's schedule does not depend on --trace: the span ticks, then two
# profiler sessions' ticks (trace.summary runs its work twice; a session
# run again takes the same ticks again)
EXTRA_TICKS = SPAN_TICKS + 2 * TRACE_TICKS


def build_server(ctx, slots: int):
    """The program's server for the configuration, with the weights'
    flat vector, on ctx.device."""
    from percepnet_tpu_torch.serve import StreamingServer
    cfg = ctx.config
    flat = program.make_weights(cfg, ctx.seed, ctx.device, ctx.repo)
    model, kw = program.build_model(flat, cfg)
    srv = StreamingServer(
        model, capacity=slots,
        model_dtype=torch.bfloat16 if program.bf16(cfg) else None,
        io_int16=cfg["wire"] == "int16",
        log1p_features=kw["log1p_features"], device=ctx.device)
    return srv, flat


def _wire(cfg) -> bool:
    return cfg["wire"] == "int16"


def drive(srv, sched, sid_of, period_s: float, k0: int, k1: int,
          paced: bool = False, on_tick=None):
    """Drive ticks k0 .. k1-1 of `sched`: on the frame clock when paced,
    else back to back.  Returns, one entry per tick, (latency_s,
    lateness_s: how late the loop started the tick on the clock, failed
    frames)."""
    audio = sched.audio
    starts: dict[int, list] = {}
    for s in sched.sessions:
        if 0 < s.start and k0 <= s.start < k1:
            starts.setdefault(s.start, []).append(s)
    lat = np.zeros(k1 - k0)
    late = np.zeros(k1 - k0)
    bad = np.zeros(k1 - k0, dtype=np.int64)
    slots = sched.slots
    t0 = time.perf_counter()
    for i, k in enumerate(range(k0, k1)):
        if paced:
            due = t0 + i * period_s
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - due
        else:
            due = time.perf_counter()
        for s in starts.get(k, ()):
            srv.detach(sid_of[s.slot])
            sid_of[s.slot] = srv.attach()
        frames = audio[:, k * FRAME : (k + 1) * FRAME]
        for slot in range(slots):
            srv.submit(sid_of[slot], frames[slot])
        outs = srv.step()
        lat[i] = time.perf_counter() - due
        if on_tick is not None:
            on_tick(k, outs)
        bad[i] = slots - sum(
            v.dtype.kind != "f" or bool(np.isfinite(v).all())
            for v in outs.values())
    return lat, late, bad


def run(ctx, paced: bool = False) -> dict:
    """One run; paced: the window on the frame clock (the sweep)."""
    dev, cfg, mix = ctx.device, ctx.config, ctx.mix
    slots = ctx.slots or mix["slots"]
    period_s = mix["frame_period_ms"] / 1e3
    ticks = max(1, int(round(ctx.seconds / period_s)))
    sched = traffic.StreamSchedule(mix, ctx.seed, slots, ticks + EXTRA_TICKS,
                                   _wire(cfg), dev)
    sample = traffic.sample_sessions(sched, mix["sample_sessions"], ctx.seed,
                                     upto=ticks)
    srv, flat = build_server(ctx, slots)
    probe = Probe(dev)
    probe.install(*srv._models)
    cap: dict[str, list] = {k: [] for k in
                            ("period", "features", "ep", "g", "r")}

    def capture(stage, out):
        if stage == "frontend":
            for k in ("period", "features", "ep"):
                cap[k].append(out[0][k][:, 0].clone())
        elif stage == "model":
            cap["g"].append(out[0][:, 0].clone())
            cap["r"].append(out[1][:, 0].clone())

    sid_of = {}
    try:
        # warm-up: a full server, every shape of the window, capture and
        # the slot reset included, so that nothing runs for the first
        # time inside the window
        probe.capture = capture
        for slot in range(slots):
            sid_of[slot] = srv.attach()
        for k in range(WARMUP_TICKS):
            for slot in range(slots):
                srv.submit(sid_of[slot], sched.audio[slot, k * FRAME :
                                                     (k + 1) * FRAME])
            srv.step()
        for slot in range(slots):
            srv.detach(sid_of[slot])
            sid_of[slot] = srv.attach()
        _sync(dev)
        for v in cap.values():
            v.clear()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        pcm_out = {id(s): np.zeros((s.frames, FRAME),
                                   np.int16 if _wire(cfg) else np.float32)
                   for s in sample}
        by_slot: dict[int, list] = {}
        for s in sample:
            by_slot.setdefault(s.slot, []).append(s)

        def keep(k, outs):
            for slot, lst in by_slot.items():
                for s in lst:
                    if s.start <= k < s.start + s.frames:
                        out = outs.get(sid_of[slot])
                        if out is not None:
                            pcm_out[id(s)][k - s.start] = out

        setup_s = time.perf_counter() - ctx.t0
        lat, late, bad = drive(srv, sched, sid_of, period_s, 0, ticks,
                               paced, keep)
        probe.capture = None
        row_of = dict(sid_of)            # the slots' rows in the window
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        if paced:
            print(f"schedule: {ticks} ticks of {slots} slots; the loop "
                  f"started ticks late by p50 {np.median(late) * 1e3:.3f} "
                  f"ms, p95 {np.percentile(late, 95) * 1e3:.3f} ms, max "
                  f"{late.max() * 1e3:.3f} ms; last tick "
                  f"{late[-1] * 1e3:.3f} ms late", file=sys.stderr)
        else:
            print(f"schedule: {ticks} ticks of {slots} slots back to back "
                  f"in {lat.sum():.3f} s; tick ms min {lat.min() * 1e3:.2f}, "
                  f"median {np.median(lat) * 1e3:.2f}, max "
                  f"{lat.max() * 1e3:.2f}", file=sys.stderr)
        layer = {"kind": "stream", "ticks": ticks, "slots": slots,
                 "latency_ms": (lat * 1e3).tolist(),
                 "lateness_ms": (late * 1e3).tolist(),
                 "precision": cfg["precision"]}
        if ctx.trace:
            # the schedule's next ticks, through the window's own drive()
            probe.spans = True
            span_lat, _, _ = drive(srv, sched, sid_of, period_s, ticks,
                                   ticks + SPAN_TICKS)
            probe.spans = False
            layer["spans"] = dict(probe.span_ms)
            layer["spans"]["tick"] = (span_lat * 1e3).tolist()
            sessions = [0]

            def traced_ticks():
                k0 = ticks + SPAN_TICKS + sessions[0] % 2 * TRACE_TICKS
                sessions[0] += 1
                drive(srv, sched, sid_of, period_s, k0, k0 + TRACE_TICKS)
            probe.ranges = True
            layer["trace"] = ctx.profile(traced_ticks, TRACE_TICKS)
            probe.ranges = False
        del srv
    finally:
        probe.uninstall()
    failed = int(bad.sum())

    # the reference over each sampled session's whole input
    n = len(sample)
    longest = max(s.frames for s in sample)
    signal = torch.zeros((n, longest * FRAME), dtype=torch.float32)
    valid = torch.zeros((n, longest), dtype=torch.bool)
    for i, s in enumerate(sample):
        signal[i, : s.frames * FRAME] = torch.from_numpy(
            sched.session_input(s))
        valid[i, : s.frames] = True
    signal, valid = signal.to(dev), valid.to(dev)
    t_ref = time.perf_counter()
    ref = R.enhance(signal, R.unflatten(flat), R.Precision.from_config(cfg),
                    cfg["features"]["log1p"])
    prog = {}
    if all(len(v) == ticks for v in cap.values()):
        for key, v in cap.items():
            per_tick = torch.stack(v)                      # [ticks, S, ...]
            rows = []
            for s in sample:
                x = per_tick[s.start : s.start + s.frames, row_of[s.slot]]
                pad = longest - s.frames
                rows.append(torch.cat([x, x.new_zeros(pad, *x.shape[1:])]))
            prog[key] = torch.stack(rows)
    prog["pcm"] = torch.from_numpy(np.stack([
        np.concatenate([pcm_out[id(s)], np.zeros(
            (longest - s.frames, FRAME), pcm_out[id(s)].dtype)])
        for s in sample])).to(dev)

    def on_wire(out):
        out["pcm"] = out["pcm"].reshape(n, longest, FRAME)
        if _wire(cfg):
            out["pcm"] = R.to_int16(out["pcm"])
        return out

    ref = on_wire(ref)
    nums = judge.numbers(prog, ref, valid)
    nums["reference_s"] = time.perf_counter() - t_ref
    if ctx.control:
        ctl = on_wire(R.enhance(signal, R.unflatten(flat),
                                R.Precision.from_config(cfg).lower(),
                                cfg["features"]["log1p"]))
        nums["control"] = judge.numbers(ctl, ref, valid)
    return {"attempted": ticks * slots, "failed": failed,
            "end_to_end": {"frame_latency_p95_ms":
                           float(np.percentile(lat, 95) * 1e3),
                           "setup_s": setup_s},
            "memory_peak_bytes": peak, "layer": layer, "numbers": nums}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
