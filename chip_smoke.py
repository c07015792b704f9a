#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (percepnet_tpu_torch) once on a CUDA card.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing one JSON progress line:
  device   the card's name, count and power limit (nvidia-smi);
  build    nvcc builds the hand-written kernels (csrc/*.cu) into
           build/percepnet_tpu_torch/ and the script times it;
  comb     the comb-filter kernel against its plain PyTorch version on the
           card, at the serving and batch shapes, timed with CUDA events;
  batch    enhance_chunk with the round-5 checkpoint at 16 streams x 200
           frames on the card, against the same call on the CPU;
  serve    StreamingServer (64 slots, 8 streams) for 100 ticks plus the
           flush, against one batched enhance_chunk on the card;
  profile  torch.profiler over 10 of those ticks: kernels per tick and the
           device's busy share.
Then a `kernels` line and, last, the result line.  Any failed check
raises and the script exits non-zero without a result line; so does a
machine without a CUDA card.
"""

from __future__ import annotations

import copy
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
CHECKPOINT = ROOT / "artifacts" / "exp_log1p_30000_params.npz"
FEATGEN = ROOT / "tests" / "goldens" / "featgen.npz"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 (non-tensor)
# rate; the card's power limit is printed beside every time.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

COMB_REL_TOL = 1e-6        # kernel vs plain version, of the output's scale
PCM_TOL = 5e-4             # card vs CPU, normalized PCM (test_nn_parity)
GR_TOL = 3e-3              # card vs CPU, gains/strengths (test_nn_parity)
SERVE_ATOL = 2e-3          # per-tick server vs one batched call (test_serve)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median device time of `runs` calls, each between two CUDA events.

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


def comb_bound(bsz: int, t: int, n_pad: int) -> tuple[float, str]:
    """Least time for the comb at this shape: every input read once and
    the output written once, or 15 flops per output at the f32 peak."""
    n_bytes = 4 * (bsz * n_pad + bsz * t + bsz * t * 960 + 960 + 7)
    flops = 15 * bsz * t * 960
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_comb(rng: np.random.Generator) -> dict:
    import torch
    from percepnet_tpu_torch.ops import comb
    shapes = [(64, 100), (64, 1), (16, 200), (3, 37)]
    rows, max_abs, max_rel = [], 0.0, 0.0
    for bsz, t in shapes:
        n_pad = t * 480 + 5280
        s_pad = torch.from_numpy(
            rng.standard_normal((bsz, n_pad)).astype(np.float32)).cuda()
        period = torch.from_numpy(
            rng.integers(60, 770, (bsz, t)).astype(np.int32)).cuda()
        got = comb.comb_cuda(s_pad, period, 2400)
        ref = comb.comb_ref(s_pad, period, 2400)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        require(bool(torch.isfinite(got).all()), f"comb finite at {bsz}x{t}")
        require(rel <= COMB_REL_TOL,
                f"comb kernel vs plain at {bsz}x{t}: {rel:.3g} > "
                f"{COMB_REL_TOL}")
        bound, bound_by = comb_bound(bsz, t, n_pad)
        row = {"B": bsz, "T": t, "max_abs_err": err, "max_rel_err": rel,
               "ms": time_ms(lambda: comb.comb_cuda(s_pad, period, 2400)),
               "plain_ms": time_ms(
                   lambda: comb.comb_ref(s_pad, period, 2400)),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
    emit("comb", tolerance_rel=COMB_REL_TOL, shapes=rows)
    return {"rows": rows, "max_abs_err": max_abs, "max_rel_err": max_rel}


def batch_input(n_streams: int, n_frames: int,
                rng: np.random.Generator) -> np.ndarray:
    """featgen's noisy clip plus seeded variants (gain, shift, added
    noise), [n_streams, n_frames*480] at /32768 scale."""
    with np.load(FEATGEN) as g:
        noisy = g["noisy16"].astype(np.float32) / 32768.0
    n = n_frames * 480
    reps = -(-n // len(noisy))
    base = np.tile(noisy, reps)[:n]
    sig = np.empty((n_streams, n), np.float32)
    sig[0] = base
    for i in range(1, n_streams):
        gain = rng.uniform(0.3, 1.5)
        shift = int(rng.integers(0, n))
        noise = rng.uniform(0.0, 0.02) * rng.standard_normal(n)
        sig[i] = (gain * np.roll(base, shift) + noise).astype(np.float32)
    return sig


def phase_batch(model_cpu, sig: np.ndarray) -> dict:
    """enhance_chunk on the card against the same call on the CPU."""
    import torch
    from percepnet_tpu_torch import enhance, pipeline
    from percepnet_tpu_torch.features import frontend
    from percepnet_tpu_torch.ops import comb

    sync = torch.cuda.synchronize
    model = copy.deepcopy(model_cpu).to("cuda")
    bsz, n = sig.shape
    kw = dict(log1p_features=True)

    def run():
        return pipeline.enhance_chunk(
            model, sig, pipeline.init_pipeline_state(bsz), return_gr=True,
            **kw)

    comb.launches = 0
    pcm, _, (g, r) = run()
    sync()
    launches = comb.launches
    require(launches > 0, "the batch main path launched the comb kernel")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        sync()
        runs.append(time.perf_counter() - t0)
    seconds = statistics.median(runs)

    pcm_c, _, (g_c, r_c) = pipeline.enhance_chunk(
        model_cpu, sig, pipeline.init_pipeline_state(bsz, device="cpu"),
        return_gr=True, device="cpu", **kw)
    pcm_err = (pcm.cpu() - pcm_c).abs().max().item()
    gr_err = max((g.cpu() - g_c).abs().max().item(),
                 (r.cpu() - r_c).abs().max().item())
    require(bool(torch.isfinite(pcm).all()) and pcm.shape == (bsz, n),
            "batch PCM finite and [B, n]")

    # pitch periods on the card vs the CPU, and where the time goes
    with torch.no_grad():
        x = torch.from_numpy(sig).cuda()
        stage = {}
        t0 = time.perf_counter()
        front, _ = frontend.analyze_batch(x)
        sync()
        stage["frontend_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        g2, r2, _ = model(front["features"], **kw)
        sync()
        stage["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enhance.enhance_spectra(front, g2, r2)
        sync()
        stage["enhance_s"] = time.perf_counter() - t0
        front_c, _ = frontend.analyze_batch(torch.from_numpy(sig))
    mismatch = (front["period"].cpu() != front_c["period"])
    frames = [[int(b), int(t)] for b, t in mismatch.nonzero()[:20].tolist()]
    out = {"B": bsz, "T": n // 480, "comb_launches": launches,
           "seconds_median_of_3": seconds,
           "audio_s_per_s": bsz * n / 48000 / seconds,
           "pcm_max_err": pcm_err, "gr_max_err": gr_err,
           "pitch_mismatches": int(mismatch.sum()),
           "pitch_mismatch_frames": frames, **stage}
    emit("batch", **out)
    require(pcm_err <= PCM_TOL, f"batch PCM card vs CPU {pcm_err:.3g}")
    require(gr_err <= GR_TOL, f"batch g/r card vs CPU {gr_err:.3g}")
    return out


def phase_serve(model_cpu, sig: np.ndarray) -> dict:
    """StreamingServer ticks on the card against one batched
    enhance_chunk there."""
    import torch
    from percepnet_tpu_torch import pipeline
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.serve import StreamingServer

    model = copy.deepcopy(model_cpu).to("cuda")
    capacity = 64
    n_streams, n = sig.shape
    n_ticks = n // 480
    srv = StreamingServer(model, capacity=capacity, log1p_features=True)
    sids = [srv.attach() for _ in range(n_streams)]
    got = {sid: [] for sid in sids}
    comb.launches = 0
    tick_s = []
    t0 = time.perf_counter()
    for t in range(n_ticks + srv.flush_frames()):
        t1 = time.perf_counter()
        if t < n_ticks:
            for i, sid in enumerate(sids):
                srv.submit(sid, sig[i, t * 480 : (t + 1) * 480])
        for sid, frame in srv.step().items():
            got[sid].append(frame)
        tick_s.append(time.perf_counter() - t1)
    seconds = time.perf_counter() - t0
    launches = comb.launches
    require(launches > 0, "the serving main path launched the comb kernel")
    total = n_ticks + srv.flush_frames()

    full = np.zeros((capacity, total * 480), np.float32)
    for i, sid in enumerate(sids):
        full[sid, :n] = sig[i]
    ref, _ = pipeline.enhance_chunk(
        model, full, pipeline.init_pipeline_state(capacity),
        log1p_features=True)
    ref = ref.cpu().numpy()
    err = float(max(np.abs(np.concatenate(got[sid]) - ref[sid]).max()
                    for sid in sids))
    peak = max(np.abs(ref[sid]).max() for sid in sids)
    out = {"capacity": capacity, "streams": n_streams, "ticks": total,
           "comb_launches": launches, "seconds": seconds,
           "ticks_per_s": total / seconds,
           "tick_ms_median": 1e3 * statistics.median(tick_s),
           "tick_ms_p90": 1e3 * float(np.percentile(tick_s, 90)),
           "max_err_vs_batch": err,
           "output_peak": float(peak)}
    emit("serve", **out)
    require(np.isfinite(err) and err <= SERVE_ATOL,
            f"server vs batch {err:.3g} > {SERVE_ATOL}")
    require(peak > 0, "server output is not all zeros")
    return out


def phase_profile(model_cpu, sig: np.ndarray, tick_ms: float) -> dict:
    """Where a serving tick's time goes: torch.profiler over 10 ticks of
    the serve phase's configuration.  Device busy share = the ticks'
    kernel and copy time over their untraced wall time (`tick_ms`, the
    serve phase's median), since tracing slows the host side."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from percepnet_tpu_torch.serve import StreamingServer

    srv = StreamingServer(copy.deepcopy(model_cpu).to("cuda"), capacity=64,
                          log1p_features=True)
    sids = [srv.attach() for _ in range(sig.shape[0])]

    def tick(t):
        for i, sid in enumerate(sids):
            srv.submit(sid, sig[i, t * 480 : (t + 1) * 480])
        srv.step()

    for t in range(3):
        tick(t)
    n_ticks = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(3, 3 + n_ticks):
            tick(t)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_ms = sum(by_name.values()) / 1e3 / n_ticks
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"ticks": n_ticks, "device_events_per_tick": len(device) / n_ticks,
           "device_ms_per_tick": device_ms, "untraced_tick_ms": tick_ms,
           "device_busy_share": device_ms / tick_ms if device else None,
           "top_device_ms_per_tick": [[name[:80], us / 1e3 / n_ticks]
                                      for name, us in top]}
    emit("profile", **out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from percepnet_tpu_torch.io.flat_npz import load_params
    from percepnet_tpu_torch.ops import kernels

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    print(smi, flush=True)
    emit("device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    compiled = kernels.build()
    kernels.library()
    emit("build", seconds=time.perf_counter() - t0, compiled=compiled,
         library=str(kernels.LIBRARY.relative_to(ROOT)))

    rng = np.random.default_rng(20261017)
    comb_res = phase_comb(rng)
    model_cpu = load_params(CHECKPOINT)
    phase_batch(model_cpu, batch_input(16, 200, rng))
    serve_sig = batch_input(8, 100, rng)
    serve = phase_serve(model_cpu, serve_sig)
    phase_profile(model_cpu, serve_sig, serve["tick_ms_median"])

    main_shape = comb_res["rows"][0]
    kernel_line = {
        "name": "comb_filter_windows", "route": "cuda",
        "source": "percepnet_tpu_torch/csrc/comb.cu",
        "replaces": "percepnet_tpu/ops/comb.py:252",
        "replaces_function": "_comb_pallas (kernel body _comb_kernel, :69)",
        "launches": serve["comb_launches"],
        "max_abs_err": comb_res["max_abs_err"],
        "max_rel_err": comb_res["max_rel_err"],
        "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "shape": [main_shape["B"], main_shape["T"]],
    }
    print(json.dumps({"kernels": [kernel_line]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
