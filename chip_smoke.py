#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (percepnet_tpu_torch) once on a CUDA card.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing one JSON progress line:
  device   the card's name, count and power limit (nvidia-smi);
  build    nvcc builds the hand-written kernels (csrc/*.cu) into
           build/percepnet_tpu_torch/ and the script times it;
  comb     through percepnet_tpu_torch.bench_comb: both comb kernels (v1
           csrc/comb.cu, the row-layout v2 csrc/comb_rows.cu), each with
           an f32 and a bf16 store, bit for bit against their plain
           PyTorch version on the card at the serving and batch shapes,
           at 3 x 37, on an edge-period input (max_period and the NaN
           frame past it in one tile, a ragged last tile, period 60) in
           several tilings, and on 4 rows of 512 x 200; then timed with
           CUDA events at 64 x 1, 16 x 200, 64 x 100 and 512 x 200 (the
           timed run is v2's path: its launch count);
  batch    enhance_chunk with the round-5 checkpoint at 16 streams x 200
           frames on the card, against the same call on the CPU;
  batch_bf16  the bf16 serving tier (compute_dtype=bfloat16) on 16
           clean/noisy pairs at the checkpoint's training scale: pitch
           periods against the f32 tier, g/r against the port's CPU run,
           and the quality check of tools/quality_gate.py (bf16 vs f32
           STOI and SI-SDR);
  serve    StreamingServer (64 slots, 8 streams) for 100 ticks plus the
           flush, against one batched enhance_chunk on the card;
  serve_bf16  the same with model_dtype=bfloat16 and io_int16=True,
           against one batched bf16 enhance_chunk, truncated alike;
  serve_raw  the float-wire f32 and bf16 servers fed 8 streams x 50 ticks
           at raw int16 amplitude, the checkpoint's training scale, each
           against one batched enhance_chunk at that scale;
  profile  torch.profiler over 10 f32 ticks: kernels per tick and the
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

COMB_REL_TOL = 1e-6        # v1 f32 kernel vs plain, of the output's scale;
                           # the bf16 stores and v2 must match bit for bit
PCM_TOL = 5e-4             # card vs CPU, normalized PCM (test_nn_parity)
GR_TOL = 3e-3              # card vs CPU, gains/strengths (test_nn_parity)
SERVE_ATOL = 2e-3          # per-tick server vs one batched call (test_serve)
# bf16 tier: g/r mean abs, bf16 vs another bf16 run (tests/test_model.py)
GR_BF16_MEAN_TOL = 0.03
# bf16 streaming vs batch, in int16 LSB: 3e-3 of full scale + 32 LSB
# (tests/test_pipeline.py:test_streaming_cli_bf16_raw_scale)
SERVE_BF16_LSB = 3e-3 * 32768 + 32
# at the wire's /32768 scale this checkpoint's output peaks near 100 LSB,
# where the LSB bound says little: each stream must also follow the batch
# call's output (a silent or shifted stream correlates far below this)
SERVE_BF16_MIN_CORR = 0.99
# bf16 vs f32 quality deltas (tools/quality_gate.py's bf16 gate)
DSTOI_TOL, DSISDR_TOL = 0.005, 0.3
# the comb kernels' shapes: checked at all, timed at the main path's four;
# the kernels line's top-level numbers are at the first
COMB_CHECK_SHAPES = ((64, 100), (64, 1), (16, 200), (3, 37), (512, 200))
COMB_TIME_SHAPES = ((64, 100), (64, 1), (16, 200), (512, 200))
COMB_EDGE_GRIDS = ((8, 1), (12, 1), (3, 3), (1, 2))


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One progress line; at_s is the script's host time so far."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - START}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase_comb(rng: np.random.Generator) -> dict:
    """Both comb kernels and both stores against the plain version, bit
    for bit, at each shape (4 rows of 512 x 200, in its own tiling too)
    and on the edge-period input in several tilings; NaN frames exactly
    where the period is out of range.  Then each is timed at the main
    path's shapes; the timed run is the bench's own path, so its
    launches of v2 are v2's count."""
    import torch
    from percepnet_tpu_torch import bench_comb
    from percepnet_tpu_torch.ops import comb
    cases = {}
    for bsz, t in COMB_CHECK_SHAPES:
        n_pad = t * 480 + 5280
        cases[f"{bsz}x{t}"] = (
            torch.from_numpy(rng.standard_normal((bsz, n_pad)).astype(
                np.float32)).cuda(),
            torch.from_numpy(rng.integers(60, 770, (bsz, t)).astype(
                np.int32)).cuda())
    cases["edge"] = bench_comb.edge_inputs()
    checked, max_abs, max_rel = {}, {}, 0.0
    for name, (s_pad, period) in cases.items():
        bsz, t = period.shape
        grids = (None, comb.tile_grid(bsz, t))
        if name == "edge":
            grids += COMB_EDGE_GRIDS
        s_chk, p_chk = bench_comb.check_slice(s_pad, period)
        checks = bench_comb.check(s_chk, p_chk, grids)
        ref = comb.comb_ref(s_chk, p_chk, 2400)
        scale = ref[torch.isfinite(ref)].abs().max().item()
        rel = checks["v1_f32"]["max_abs_err"] / scale
        max_p = comb.max_period(t, s_pad.shape[1], 2400)
        out_of_range = (p_chk < 0) | (p_chk > max_p)
        got = comb.comb_cuda(s_chk, p_chk, 2400)
        require(torch.equal(torch.isnan(got).all(-1), out_of_range)
                and bool(torch.isfinite(got[~out_of_range]).all()),
                f"comb NaN frames exactly the out-of-range ones at {name}")
        require(rel <= COMB_REL_TOL,
                f"comb v1 f32 vs plain at {name}: {rel:.3g} > "
                f"{COMB_REL_TOL}")
        require(bench_comb.all_exact(checks),
                f"comb kernels and stores bit for bit at {name}: {checks}")
        for k, v in checks.items():
            if isinstance(v, dict):
                max_abs[k] = max(max_abs.get(k, 0.0), v["max_abs_err"])
        max_rel = max(max_rel, rel)
        checked[name] = {"B": bsz, "T": t, "rows_checked": p_chk.shape[0],
                         "grids": [list(g) if g else "default"
                                   for g in grids],
                         "nan_frames": int(out_of_range.sum()),
                         "v1_f32_max_rel_err": rel, "checks": checks}
    torch.cuda.synchronize()
    comb.reset_launches()
    timed = {}
    for bsz, t in COMB_TIME_SHAPES:
        timed[f"{bsz}x{t}"] = {"B": bsz, "T": t,
                               "grid": list(comb.tile_grid(bsz, t)),
                               "ms": bench_comb.time_variants(
                                   *cases[f"{bsz}x{t}"])}
    torch.cuda.synchronize()
    rows_launches = {store: comb.launches[f"rows_{store}"]
                     for store in ("f32", "bf16")}
    require(min(rows_launches.values()) > 0,
            "the bench path launched the v2 kernel in both stores")
    emit("comb", tolerance_rel_v1_f32=COMB_REL_TOL,
         v2_launches_in_bench=rows_launches, checked=checked, timed=timed)
    return {"timed": timed, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "v2_launches": rows_launches}


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

    comb.reset_launches()
    pcm, _, (g, r) = run()
    sync()
    launches = comb.launches["windows_f32"]
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


def quality_pairs(n_pairs: int, rng: np.random.Generator):
    """featgen's clean/noisy pair plus seeded variants (gain and circular
    shift, the same for both signals of a pair), [n_pairs, 96000] each at
    raw int16 amplitude, the checkpoint's training scale."""
    with np.load(FEATGEN) as g:
        clean = g["clean16"].astype(np.float32)
        noisy = g["noisy16"].astype(np.float32)
    cs, ns = [clean], [noisy]
    for _ in range(1, n_pairs):
        gain = rng.uniform(0.3, 1.5)
        shift = int(rng.integers(0, clean.size))
        cs.append(gain * np.roll(clean, shift))
        ns.append(gain * np.roll(noisy, shift))
    return np.stack(cs), np.stack(ns)


def quality(clean: np.ndarray, enhanced: np.ndarray,
            align: bool = True) -> dict:
    """STOI and SI-SDR of one stream against its clean reference, both at
    raw int16 amplitude, as tools/quality_gate.py measures them: C-cast
    to int16, /32768, and with `align` the enhancer's delay compensated
    by the best SI-SDR of the candidate lags (cli/evaluate.evaluate_pair).
    """
    from percepnet_tpu_torch.utils import metrics

    def pcm(x):
        return np.trunc(np.clip(x, -32768, 32767)) / 32768.0
    ref, enh = pcm(clean), pcm(enhanced)
    if align:
        lags = (0, 5 * 480, 6 * 480)
        sdr = [metrics.si_sdr_db(ref[: enh.size - lag], enh[lag:])
               for lag in lags]
        enh = enh[lags[int(np.argmax(sdr))]:]
    m = min(ref.size, enh.size)
    return {"stoi": metrics.stoi(ref[:m], enh[:m]),
            "si_sdr_db": metrics.si_sdr_db(ref[:m], enh[:m])}


def phase_batch_bf16(model_cpu, clean: np.ndarray, noisy: np.ndarray,
                     ) -> dict:
    """The bf16 serving tier on the card: pitch periods against the f32
    tier, g/r against the port's CPU bf16 run, and the bf16 vs f32
    quality deltas."""
    import torch
    from percepnet_tpu_torch import pipeline
    from percepnet_tpu_torch.features import frontend
    from percepnet_tpu_torch.ops import comb

    sync = torch.cuda.synchronize
    bf16 = torch.bfloat16
    model = copy.deepcopy(model_cpu).to("cuda")
    model16 = copy.deepcopy(model).to(bf16)
    bsz, n = noisy.shape
    # the flush frames drain the lookahead, as cli/enhance does
    sig = np.zeros((bsz, n + pipeline.flush_frames() * 480), np.float32)
    sig[:, :n] = noisy

    def run(m, dtype, dev="cuda"):
        kw = {"compute_dtype": bf16} if dtype == bf16 else {}
        out = pipeline.enhance_chunk(
            m, sig, pipeline.init_pipeline_state(
                bsz, model_dtype=dtype, device=dev),
            return_gr=True, device=dev, log1p_features=True, **kw)
        if dev == "cuda":
            sync()
        return out

    comb.reset_launches()
    pcm16, _, (g16, r16) = run(model16, bf16)
    launches = comb.launches["windows_bf16"]
    require(launches > 0, "the bf16 tier launched the bf16 comb kernel")
    require(comb.launches["windows_f32"] == 0,
            "the bf16 tier stores the comb in bf16 only")
    pcm32, _, _ = run(model, torch.float32)
    seconds = {}
    for tag, m, dtype in (("f32", model, torch.float32),
                          ("bf16", model16, bf16)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(m, dtype)
            runs.append(time.perf_counter() - t0)
        seconds[tag] = statistics.median(runs)
    _, _, (g16c, r16c) = run(model_cpu, bf16, "cpu")
    require(bool(torch.isfinite(pcm16).all()) and pcm16.shape == sig.shape
            and pcm16.dtype == torch.float32, "bf16 PCM finite, [B, n], f32")
    gr = {}
    for k, a, b in (("g", g16, g16c), ("r", r16, r16c)):
        d = (a.cpu() - b).abs()
        gr[f"{k}_mean_abs"], gr[f"{k}_max_abs"] = d.mean().item(), \
            d.max().item()

    with torch.no_grad():
        x = torch.from_numpy(sig).cuda()
        f32_front, _ = frontend.analyze_batch(x)
        bf16_front, _ = frontend.analyze_batch(x, serving=True)
    mismatch = int((f32_front["period"] != bf16_front["period"]).sum())

    t0 = time.perf_counter()
    q = {}
    streams = {"noisy": noisy}
    for tag, pcm in (("f32", pcm32), ("bf16", pcm16)):
        # the first output frame is dropped, as cli/enhance writes it
        streams[tag] = pcm.cpu().numpy()[:, 480:n]
    for tag, enh in streams.items():
        rows = [quality(clean[i], enh[i], align=tag != "noisy")
                for i in range(bsz)]
        q[tag] = {k: float(np.mean([r[k] for r in rows]))
                  for k in ("stoi", "si_sdr_db")}
    quality_s = time.perf_counter() - t0
    delta = {k: q["bf16"][k] - q["f32"][k] for k in ("stoi", "si_sdr_db")}
    audio_s = bsz * n / 48000
    out = {"pairs": bsz, "T": n // 480, "comb_bf16_launches": launches,
           "seconds_median_of_3": seconds,
           "audio_s_per_s": {k: audio_s / v for k, v in seconds.items()},
           "pitch_mismatches_bf16_vs_f32": mismatch,
           "gr_card_vs_cpu_bf16": gr, "quality": q, "bf16_delta": delta,
           "quality_host_s": quality_s,
           "bounds": {"gr_mean_abs": GR_BF16_MEAN_TOL, "stoi": DSTOI_TOL,
                      "si_sdr_db": DSISDR_TOL}}
    emit("batch_bf16", **out)
    require(mismatch == 0, f"bf16 vs f32 pitch periods: {mismatch} differ")
    require(max(gr["g_mean_abs"], gr["r_mean_abs"]) <= GR_BF16_MEAN_TOL,
            f"bf16 g/r card vs CPU mean {gr}")
    require(abs(delta["stoi"]) <= DSTOI_TOL
            and abs(delta["si_sdr_db"]) <= DSISDR_TOL,
            f"bf16 vs f32 quality deltas {delta}")
    return out


def run_ticks(srv, sig: np.ndarray) -> dict:
    """Attach one stream per row of sig (samples in the server's wire
    type), feed them one frame per tick, then the flush; returns the
    slots, each stream's output, each tick's host time and the total."""
    n_streams, n = sig.shape
    n_ticks = n // 480
    sids = [srv.attach() for _ in range(n_streams)]
    got = {sid: [] for sid in sids}
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
    return {"sids": sids, "got": {k: np.concatenate(v) for k, v in
                                  got.items()},
            "tick_s": tick_s, "seconds": time.perf_counter() - t0}


def tick_stats(run: dict) -> dict:
    ticks = len(run["tick_s"])
    return {"ticks": ticks, "seconds": run["seconds"],
            "ticks_per_s": ticks / run["seconds"],
            "tick_ms_median": 1e3 * statistics.median(run["tick_s"]),
            "tick_ms_p90": 1e3 * float(np.percentile(run["tick_s"], 90))}


def phase_serve(model_cpu, sig: np.ndarray) -> dict:
    """StreamingServer ticks on the card against one batched
    enhance_chunk there."""
    from percepnet_tpu_torch import pipeline
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.serve import StreamingServer

    model = copy.deepcopy(model_cpu).to("cuda")
    capacity = 64
    n_streams, n = sig.shape
    srv = StreamingServer(model, capacity=capacity, log1p_features=True)
    comb.reset_launches()
    res = run_ticks(srv, sig)
    launches = comb.launches["windows_f32"]
    require(launches > 0, "the serving main path launched the comb kernel")
    stats = tick_stats(res)

    full = np.zeros((capacity, stats["ticks"] * 480), np.float32)
    for i, sid in enumerate(res["sids"]):
        full[sid, :n] = sig[i]
    ref, _ = pipeline.enhance_chunk(
        model, full, pipeline.init_pipeline_state(capacity),
        log1p_features=True)
    ref = ref.cpu().numpy()
    err = float(max(np.abs(res["got"][sid] - ref[sid]).max()
                    for sid in res["sids"]))
    peak = max(np.abs(ref[sid]).max() for sid in res["sids"])
    out = {"capacity": capacity, "streams": n_streams,
           "comb_launches": launches, **stats, "max_err_vs_batch": err,
           "output_peak": float(peak)}
    emit("serve", **out)
    require(np.isfinite(err) and err <= SERVE_ATOL,
            f"server vs batch {err:.3g} > {SERVE_ATOL}")
    require(peak > 0, "server output is not all zeros")
    return out


def phase_serve_bf16(model_cpu, sig: np.ndarray, f32: dict) -> dict:
    """The bf16 server with int16 PCM on the wire against one batched bf16
    enhance_chunk on the card, truncated to int16 alike."""
    import torch
    from percepnet_tpu_torch import pipeline
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.serve import StreamingServer

    bf16 = torch.bfloat16
    model = copy.deepcopy(model_cpu).to("cuda")
    capacity = 64
    n_streams, n = sig.shape
    pcm16 = np.trunc(np.clip(sig * 32768.0, -32768, 32767)).astype(np.int16)
    srv = StreamingServer(model, capacity=capacity, model_dtype=bf16,
                          io_int16=True, log1p_features=True)
    comb.reset_launches()
    res = run_ticks(srv, pcm16)
    launches = comb.launches["windows_bf16"]
    require(launches > 0, "the bf16 server launched the bf16 comb kernel")
    stats = tick_stats(res)

    full = np.zeros((capacity, stats["ticks"] * 480), np.float32)
    for i, sid in enumerate(res["sids"]):
        full[sid, :n] = pcm16[i].astype(np.float32) / 32768.0
    ref, _ = pipeline.enhance_chunk(
        copy.deepcopy(model).to(bf16), full,
        pipeline.init_pipeline_state(capacity, model_dtype=bf16),
        compute_dtype=bf16, log1p_features=True)
    ref = torch.clamp(ref * 32768.0, -32768.0, 32767.0).to(
        torch.int16).cpu().numpy()
    got = {sid: v for sid, v in res["got"].items()}
    require(all(v.dtype == np.int16 for v in got.values()),
            "the int16 wire returns int16")
    diff = [np.abs(got[sid].astype(np.int32) - ref[sid]) for sid in got]
    err = int(max(d.max() for d in diff))
    peak = int(max(np.abs(ref[sid].astype(np.int32)).max() for sid in got))
    corr = float(min(np.corrcoef(got[sid].astype(np.float64),
                                 ref[sid].astype(np.float64))[0, 1]
                     for sid in got))
    out = {"capacity": capacity, "streams": n_streams,
           "comb_bf16_launches": launches, **stats,
           "max_err_vs_batch_lsb": err, "bound_lsb": SERVE_BF16_LSB,
           "min_corr_bound": SERVE_BF16_MIN_CORR,
           "mean_err_vs_batch_lsb": float(np.mean(np.concatenate(diff))),
           "min_corr_vs_batch": corr, "output_peak_lsb": peak,
           "f32_server": {k: f32[k] for k in ("ticks_per_s",
                                              "tick_ms_median",
                                              "tick_ms_p90")}}
    emit("serve_bf16", **out)
    require(err <= SERVE_BF16_LSB,
            f"bf16 server vs batch {err} LSB > {SERVE_BF16_LSB}")
    require(peak > 0, "bf16 server output is not all zeros")
    require(corr >= SERVE_BF16_MIN_CORR,
            f"bf16 server vs batch correlation {corr:.6f} < "
            f"{SERVE_BF16_MIN_CORR}")
    return out


def phase_serve_raw(model_cpu, sig: np.ndarray) -> dict:
    """The float-wire servers, f32 and bf16, fed the streams at raw int16
    amplitude (sig * 32768), the scale the checkpoint was trained at, so
    that the output is large beside the bounds; each against one batched
    enhance_chunk on the card at that scale (the float wire does not
    rescale)."""
    import torch
    from percepnet_tpu_torch import pipeline
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.serve import StreamingServer

    bf16 = torch.bfloat16
    model = copy.deepcopy(model_cpu).to("cuda")
    capacity = 64
    raw = sig * 32768.0
    n_streams, n = raw.shape
    out = {"capacity": capacity, "streams": n_streams, "T": n // 480}
    for tag, dtype, bound in (("f32", torch.float32, SERVE_ATOL * 32768.0),
                              ("bf16", bf16, SERVE_BF16_LSB)):
        srv = StreamingServer(model, capacity=capacity, model_dtype=dtype,
                              log1p_features=True)
        comb.reset_launches()
        res = run_ticks(srv, raw)
        launches = comb.launches[f"windows_{tag}"]
        require(launches > 0,
                f"the raw-scale {tag} server launched the {tag} comb kernel")
        ticks = len(res["tick_s"])
        full = np.zeros((capacity, ticks * 480), np.float32)
        for i, sid in enumerate(res["sids"]):
            full[sid, :n] = raw[i]
        kw = {"compute_dtype": bf16} if dtype == bf16 else {}
        ref, _ = pipeline.enhance_chunk(
            copy.deepcopy(model).to(dtype), full,
            pipeline.init_pipeline_state(capacity, model_dtype=dtype),
            log1p_features=True, **kw)
        ref = ref.cpu().numpy()
        got = res["got"]
        err = float(max(np.abs(got[sid] - ref[sid]).max() for sid in got))
        peak = float(max(np.abs(ref[sid]).max() for sid in got))
        corr = float(min(np.corrcoef(got[sid].astype(np.float64),
                                     ref[sid].astype(np.float64))[0, 1]
                         for sid in got))
        out[tag] = {"comb_launches": launches, "ticks": ticks,
                    "max_err_vs_batch": err, "bound": bound,
                    "output_peak": peak, "bound_over_peak": bound / peak,
                    "err_over_bound": err / bound,
                    "min_corr_vs_batch": corr,
                    "min_corr_bound": SERVE_BF16_MIN_CORR}
    emit("serve_raw", **out)
    for tag in ("f32", "bf16"):
        r = out[tag]
        require(np.isfinite(r["max_err_vs_batch"])
                and r["max_err_vs_batch"] <= r["bound"],
                f"raw-scale {tag} server vs batch {r['max_err_vs_batch']:.4g}"
                f" > {r['bound']:.4g}")
        require(r["output_peak"] > 0, f"raw-scale {tag} output not zeros")
        require(r["min_corr_vs_batch"] >= SERVE_BF16_MIN_CORR,
                f"raw-scale {tag} server vs batch correlation "
                f"{r['min_corr_vs_batch']:.6f} < {SERVE_BF16_MIN_CORR}")
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
    phase_batch_bf16(model_cpu, *quality_pairs(
        16, np.random.default_rng(20261018)))
    serve = phase_serve(model_cpu, serve_sig)
    serve16 = phase_serve_bf16(model_cpu, serve_sig, serve)
    phase_serve_raw(model_cpu, serve_sig[:, : 50 * 480])
    phase_profile(model_cpu, serve_sig, serve["tick_ms_median"])

    timed = comb_res["timed"]
    main_shape = next(iter(timed.values()))

    def entry(name, source, replaces, function, launches, variant, store):
        ms = main_shape["ms"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_function": function,
            "launches": launches,
            "max_abs_err": comb_res["max_abs_err"][f"{variant}_{store}"],
            "ms": ms[f"{variant}_{store}"],
            "plain_ms": ms[f"plain_{store}"],
            "bound_ms": ms[f"bound_{store}"], "bound_by": ms["bound_by"],
            "library_ms": None, "store": store,
            "shape": [main_shape["B"], main_shape["T"]],
            "shapes": {key: {"ms": row["ms"][f"{variant}_{store}"],
                             "plain_ms": row["ms"][f"plain_{store}"],
                             "bound_ms": row["ms"][f"bound_{store}"],
                             "share_of_bound":
                                 row["ms"][f"share_{variant}_{store}"],
                             "grid": row["grid"]}
                       for key, row in timed.items()}}

    b1 = ("percepnet_tpu_torch/csrc/comb.cu", "percepnet_tpu/ops/comb.py:252",
          "_comb_pallas (kernel body _comb_kernel, :69)")
    b2 = ("percepnet_tpu_torch/csrc/comb_rows.cu",
          "percepnet_tpu/ops/comb.py:202",
          "_comb_pallas_v2 (kernel body _comb_kernel_v2, :135)")
    v2_path = "percepnet_tpu_torch.bench_comb (never dispatched)"
    kernel_lines = [
        entry("comb_filter_windows", *b1, serve["comb_launches"], "v1",
              "f32"),
        entry("comb_filter_windows_bf16", *b1,
              serve16["comb_bf16_launches"], "v1", "bf16"),
        entry("comb_filter_windows_rows", *b2,
              comb_res["v2_launches"]["f32"], "v2", "f32"),
        entry("comb_filter_windows_rows_bf16", *b2,
              comb_res["v2_launches"]["bf16"], "v2", "bf16"),
    ]
    kernel_lines[0]["max_rel_err"] = comb_res["max_rel_err"]
    for line in kernel_lines[2:]:
        line["launches_path"] = v2_path
    print(json.dumps({"kernels": kernel_lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
