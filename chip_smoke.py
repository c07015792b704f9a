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
           device's busy share;
  cli_enhance  `python -m percepnet_tpu_torch enhance` in process on two
           files (featgen's noisy clip and a seeded 137-frame variant)
           with the round-5 checkpoint: f32 batch with --dump-gr against
           one enhance_chunk on the card, --streaming --report-latency
           against the batch output, and --bf16 against f32;
  featgen  `featgen clean noisy 200 out.f32 --test` on the card against
           the C binary's records and oracle PCM (featgen.npz), then 16
           seeded pairs through --pairs-file --batch 16: records/s;
  bench    the port's bench (percepnet_tpu_torch.bench.run) at 64 x 200
           in f32 and bf16: its JSON lines and peak memory; and the
           frontend / model / enhance split of one call at 512 x 200.
Then a `kernels` line and, last, the result line.  Any failed check
raises and the script exits non-zero without a result line; so does a
machine without a CUDA card.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import pathlib
import statistics
import sys
import tempfile
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
# the kernels line's top-level numbers are at the first.  Besides those,
# the shapes the command paths give B1: featgen's one pair (1 x 200), the
# batch CLI's chunks of two files (2 x 64), the streaming CLI's steps
# (1 x 1) and the bench in this script (64 x 200); phase comb_paths
# checks any other shape a driven path launched B1 at
COMB_CHECK_SHAPES = ((64, 100), (64, 1), (16, 200), (3, 37), (512, 200),
                     (1, 200), (2, 64), (1, 1), (64, 200))
COMB_TIME_SHAPES = ((64, 100), (64, 1), (16, 200), (512, 200))
COMB_EDGE_GRIDS = ((8, 1), (12, 1), (3, 3), (1, 2))
# the CLI on the card against one enhance_chunk there, in int16 LSB, and
# its --dump-gr g/r (the GRU-amplified bound for reassociated arithmetic);
# streaming (T=1 steps) against the batch CLI
CLI_LSB, CLI_GR_TOL, STREAM_LSB = 1, 1e-3, 2
CLI_BATCH_FRAMES = 64      # chunks of the batch CLI: 4 over 206 frames
# featgen's records on the card against the C binary's (featgen.npz),
# set before the first run on the card: periods exact; band energies
# relative (floor 1e-3), coherence absolute, pitch correlation relative,
# g absolute (the card-vs-CPU g/r bound of section 2 of PERF.md); r
# entries off by > 0.02: the CPU's pinned count (1) plus a budget of 2;
# oracle PCM normalized (the card's PCM bound)
FEATGEN_CARD = {"energy_rel": 1e-3, "coherence": 1e-3, "corr_rel": 1e-2,
                "g": 3e-3, "r_flips": 1 + 2, "r_median": 1e-4,
                "pcm": 5e-4}
# the CPU bounds of tests/test_featgen_parity.py, printed beside them
FEATGEN_CPU = {"energy_rel": 1e-4, "coherence": 1e-4, "corr_rel": 1e-3,
               "g": 1e-4, "r_flips": 1, "r_median": 1e-5, "pcm": 1e-4}
# each r flip must sit at a borderline r = 0.99 override: the margin
# Ephatp - Exp there, from the card's analyses, within this
# (tests/test_featgen_parity.py's bound)
FEATGEN_FLIP_MARGIN = 5e-4
FEATGEN_PAIRS = 16
BENCH_SHAPE = (64, 200)
BENCH_SPLIT_SHAPE = (512, 200)    # the bench's own shape


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One progress line; at_s is the script's host time so far."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - START}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# B1's shapes on the driven paths: {(entry point, B, T, n_pad): [paths]}
PATH_SHAPES: dict[tuple, list[str]] = {}


def launched(path: str, store: str) -> int:
    """B1's launches in `store` since comb.reset_launches(); notes the
    shapes of every B1 launch since then under `path`."""
    from percepnet_tpu_torch.ops import comb
    for shape in comb.launch_shapes:
        if shape[0].startswith("windows_"):
            PATH_SHAPES.setdefault(shape, []).append(path)
    return comb.launches[f"windows_{store}"]


def comb_inputs(bsz: int, t: int, rng: np.random.Generator,
                n_pad: int | None = None):
    """Seeded s_pad [B, n_pad] (by default t*480 + 5280, the frontend's
    length) and periods in the pitch search's range, on the card."""
    import torch
    n_pad = n_pad or t * 480 + 5280
    return (torch.from_numpy(rng.standard_normal((bsz, n_pad)).astype(
                np.float32)).cuda(),
            torch.from_numpy(rng.integers(60, 770, (bsz, t)).astype(
                np.int32)).cuda())


def check_comb_case(name: str, s_pad, period, grids=()) -> dict:
    """Both comb kernels and both stores against the plain version at one
    input, in the wrapper's tiling and each of `grids`: bit for bit, v1
    f32 within COMB_REL_TOL of scale, NaN frames exactly where the period
    is out of range.  Raises on a failed check."""
    import torch
    from percepnet_tpu_torch import bench_comb
    from percepnet_tpu_torch.ops import comb
    bsz, t = period.shape
    grids = (None, comb.tile_grid(bsz, t)) + tuple(grids)
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
            f"comb v1 f32 vs plain at {name}: {rel:.3g} > {COMB_REL_TOL}")
    require(bench_comb.all_exact(checks),
            f"comb kernels and stores bit for bit at {name}: {checks}")
    return {"B": bsz, "T": t, "n_pad": s_pad.shape[1],
            "rows_checked": p_chk.shape[0],
            "grids": [list(g) if g else "default" for g in grids],
            "nan_frames": int(out_of_range.sum()),
            "v1_f32_max_rel_err": rel, "checks": checks}


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
    cases = {f"{bsz}x{t}": comb_inputs(bsz, t, rng)
             for bsz, t in COMB_CHECK_SHAPES}
    cases["edge"] = bench_comb.edge_inputs()
    checked, max_abs, max_rel = {}, {}, 0.0
    for name, (s_pad, period) in cases.items():
        row = check_comb_case(name, s_pad, period,
                              COMB_EDGE_GRIDS if name == "edge" else ())
        for k, v in row["checks"].items():
            if isinstance(v, dict):
                max_abs[k] = max(max_abs.get(k, 0.0), v["max_abs_err"])
        max_rel = max(max_rel, row["v1_f32_max_rel_err"])
        checked[name] = row
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


def stage_seconds(model, x, **kw) -> tuple[dict, dict]:
    """Host seconds of enhance_chunk's three stages on the card, each
    ended by a synchronize: (seconds per stage, the frontend's output).
    compute_dtype=bfloat16 in kw runs the bf16 tier's stages."""
    import torch
    from percepnet_tpu_torch import enhance
    from percepnet_tpu_torch.features import frontend

    serving = kw.get("compute_dtype") == torch.bfloat16
    sync = torch.cuda.synchronize
    stage = {}
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        front, _ = frontend.analyze_batch(x, serving=serving)
        sync()
        stage["frontend_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        g, r, _ = model(front["features"], **kw)
        sync()
        stage["model_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enhance.enhance_spectra(front, g, r, serving=serving)
        sync()
        stage["enhance_s"] = time.perf_counter() - t0
    return stage, front


def phase_batch(model_cpu, sig: np.ndarray) -> dict:
    """enhance_chunk on the card against the same call on the CPU."""
    import torch
    from percepnet_tpu_torch import pipeline
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
    launches = launched("batch", "f32")
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
    stage, front = stage_seconds(model, torch.from_numpy(sig).cuda(), **kw)
    with torch.no_grad():
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
    launches = launched("batch_bf16", "bf16")
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
    launches = launched("serve", "f32")
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
    launches = launched("serve_bf16", "bf16")
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
        launches = launched(f"serve_raw_{tag}", tag)
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
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.serve import StreamingServer

    srv = StreamingServer(copy.deepcopy(model_cpu).to("cuda"), capacity=64,
                          log1p_features=True)
    sids = [srv.attach() for _ in range(sig.shape[0])]

    def tick(t):
        for i, sid in enumerate(sids):
            srv.submit(sid, sig[i, t * 480 : (t + 1) * 480])
        srv.step()

    comb.reset_launches()
    for t in range(3):
        tick(t)
    n_ticks = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(3, 3 + n_ticks):
            tick(t)
    torch.cuda.synchronize()
    launched("profile", "f32")
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


def dispatch(*argv: str) -> str:
    """`python -m percepnet_tpu_torch <argv>` in this process, on the
    card; returns what it printed."""
    from percepnet_tpu_torch import __main__ as dispatcher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dispatcher.main(list(argv))
    return buf.getvalue()


def read_pcm(path) -> np.ndarray:
    return np.fromfile(path, "<i2").astype(np.int64)


def phase_cli_enhance(tmp: pathlib.Path, rng: np.random.Generator,
                      smi: str) -> dict:
    """The enhance CLI on the card: f32 batch (--dump-gr) against one
    enhance_chunk of each file plus the flush frames, streaming against
    batch, bf16 against f32; B1's launches on each run."""
    import torch
    from percepnet_tpu_torch import pipeline
    from percepnet_tpu_torch.io.flat_npz import load_params
    from percepnet_tpu_torch.ops import comb

    with np.load(FEATGEN) as g:
        noisy = g["noisy16"].astype(np.float64)
    variant = (rng.uniform(0.7, 1.3) * np.roll(noisy, int(rng.integers(
        0, noisy.size))) + rng.normal(0.0, 100.0, noisy.size))[
            : 137 * 480 + 77]
    files = [tmp / "noisy.pcm", tmp / "variant.pcm"]
    for path, x in zip(files, (noisy, variant)):
        np.trunc(np.clip(x, -32768, 32767)).astype("<i2").tofile(path)
    weights = ["--weights", str(CHECKPOINT), "--log1p", "--raw-scale"]
    ins = [str(f) for f in files]
    launches = {}

    def run(tag, store, *argv):
        comb.reset_launches()
        printed = dispatch("enhance", *argv, *weights)
        torch.cuda.synchronize()
        launches[tag] = launched(f"cli_enhance_{tag}", store)
        require(launches[tag] > 0, f"the {tag} CLI launched the {store} "
                                   f"comb kernel")
        return printed

    run("batch", "f32", *ins, "--out-dir", str(tmp / "f32"), "--dump-gr",
        "--batch-frames", str(CLI_BATCH_FRAMES))
    printed = run("streaming", "f32", ins[0], str(tmp / "stream.pcm"),
                  "--streaming", "--report-latency")
    step_ms = float(printed.split("per-frame step time:")[1].split()[0])
    run("bf16", "bf16", *ins, "--out-dir", str(tmp / "bf16"), "--bf16",
        "--batch-frames", str(CLI_BATCH_FRAMES))

    model = load_params(CHECKPOINT).to("cuda")
    out = {"files": {}, "launches": launches, "streaming_step_ms": step_ms,
           "step_budget_ms": 10.0, "card": smi,
           "bounds": {"cli_vs_direct_lsb": CLI_LSB, "gr": CLI_GR_TOL,
                      "stream_vs_batch_lsb": STREAM_LSB,
                      "bf16_vs_f32_lsb": SERVE_BF16_LSB,
                      "bf16_min_corr": SERVE_BF16_MIN_CORR}}
    for path in files:
        x = np.fromfile(path, "<i2").astype(np.float32)
        nf = x.size // 480
        sig = np.zeros((1, (nf + pipeline.flush_frames()) * 480), np.float32)
        sig[0, : x.size] = x
        ref, _, (g, r) = pipeline.enhance_chunk(
            model, sig, pipeline.init_pipeline_state(1), return_gr=True,
            log1p_features=True)
        ref = np.trunc(np.clip(ref[0, 480 : nf * 480].cpu().numpy(),
                               -32768, 32767)).astype(np.int64)
        got = read_pcm(tmp / "f32" / path.name)
        gr = np.fromfile(tmp / "f32" / (path.name + ".gr.raw"), "<f4")
        ref_gr = torch.cat([g, r], -1)[0, :nf].cpu().numpy()
        got16 = read_pcm(tmp / "bf16" / path.name)
        row = {"frames": nf, "output_peak_lsb": int(np.abs(ref).max()),
               "shape_ok": got.shape == ref.shape and got16.shape ==
               ref.shape and gr.size == nf * 68,
               "cli_vs_direct_lsb": int(np.abs(got - ref).max())
               if got.shape == ref.shape else None,
               "gr_max_err": float(np.abs(gr - ref_gr.reshape(-1)).max())
               if gr.size == ref_gr.size else None,
               "bf16_vs_f32_lsb": int(np.abs(got16 - got).max())
               if got16.shape == got.shape else None,
               "bf16_corr": float(np.corrcoef(got16, got)[0, 1])
               if got16.shape == got.shape else None}
        if path == files[0]:
            stream = read_pcm(tmp / "stream.pcm")
            row["stream_vs_batch_lsb"] = int(np.abs(stream - got).max()) \
                if stream.shape == got.shape else None
        out["files"][path.name] = row
    emit("cli_enhance", **out)
    for name, row in out["files"].items():
        require(row["shape_ok"], f"{name}: CLI outputs have the input's "
                                 f"frames")
        require(row["cli_vs_direct_lsb"] <= CLI_LSB,
                 f"{name}: CLI vs enhance_chunk {row['cli_vs_direct_lsb']} "
                 f"LSB")
        require(row["gr_max_err"] <= CLI_GR_TOL,
                f"{name}: --dump-gr vs enhance_chunk {row['gr_max_err']}")
        require(row["bf16_vs_f32_lsb"] <= SERVE_BF16_LSB
                and row["bf16_corr"] >= SERVE_BF16_MIN_CORR,
                f"{name}: bf16 vs f32 {row['bf16_vs_f32_lsb']} LSB, "
                f"correlation {row['bf16_corr']}")
        require(row["output_peak_lsb"] > 0, f"{name}: output not zeros")
    stream = out["files"][files[0].name]["stream_vs_batch_lsb"]
    require(stream is not None and stream <= STREAM_LSB,
            f"streaming vs batch CLI {stream} LSB")
    require(np.isfinite(step_ms), "streaming step time reported")
    return out


def featgen_errors(rec: np.ndarray, ref: np.ndarray) -> dict:
    """Records against the C binary's, in the terms of
    tests/test_featgen_parity.py."""
    def relerr(a, b):
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max())
    r_diff = np.abs(rec[:, 104:138] - ref[:, 104:138])
    flips = np.argwhere(r_diff > 0.02)
    return {"period_mismatches": int((np.round(rec[:, 68] * 588)
                                      != np.round(ref[:, 68] * 588)).sum()),
            "energy_rel": relerr(rec[:, :34], ref[:, :34]),
            "coherence": float(np.abs(rec[:, 34:68] - ref[:, 34:68]).max()),
            "corr_rel": relerr(rec[:, 69], ref[:, 69]),
            "g": float(np.abs(rec[:, 70:104] - ref[:, 70:104]).max()),
            "r_flips": len(flips), "r_flip_at": flips.tolist(),
            "r_median": float(np.median(r_diff))}


def phase_featgen(tmp: pathlib.Path, smi: str) -> dict:
    """featgen on the card: one pair with --test against the C binary's
    records and oracle PCM, each r flip at a borderline override margin,
    then FEATGEN_PAIRS seeded pairs batched; records per second and B1's
    launches for each."""
    import torch
    from percepnet_tpu_torch.features import labels
    from percepnet_tpu_torch.features.frontend import analyze_utterance
    from percepnet_tpu_torch.ops import comb

    with np.load(FEATGEN) as g:
        clean, noisy = g["clean16"], g["noisy16"]
        ref, oracle = g["records"], g["oracle_pcm"].astype(np.float64)
    (tmp / "one").mkdir()
    paths = [tmp / "one" / n for n in ("clean.pcm", "noisy.pcm", "out.f32")]
    clean.astype("<i2").tofile(paths[0])
    noisy.astype("<i2").tofile(paths[1])
    launches, seconds = {}, {}
    comb.reset_launches()
    t0 = time.perf_counter()
    dispatch("featgen", str(paths[0]), str(paths[1]), "200", str(paths[2]),
             "--test")
    seconds["one_pair"] = time.perf_counter() - t0
    launches["one_pair"] = launched("featgen_one_pair", "f32")
    require(launches["one_pair"] > 0, "featgen launched the comb kernel")
    rec = np.fromfile(paths[2], "<f4").reshape(-1, 138)
    errors = featgen_errors(rec, ref)
    out_pcm = read_pcm(tmp / "one" / "test_output.pcm").astype(np.float64)
    n = min(out_pcm.size, oracle.size)
    errors["pcm"] = float(np.abs(out_pcm[:n] - oracle[:n]).max() / 32768)
    # the override's margin at each flip, from the card's own analyses of
    # the pair's 200 frames as featgen makes them, and beside it the
    # margin the port's CPU tier computes there
    margins = {}
    for dev in ("cuda", "cpu"):
        frames = []
        for x in (clean, noisy):
            x32 = np.zeros(200 * 480, np.float32)
            x32[: min(x.size, x32.size)] = x[: x32.size]
            with torch.no_grad():
                frames.append(analyze_utterance(
                    torch.from_numpy(x32).to(dev))[0])
        margin = (labels.estimate_phat_corr(frames[1]["exp"])
                  - frames[0]["exp"]).cpu().numpy()
        margins[dev] = [float(margin[t, b]) for t, b in errors["r_flip_at"]]
    errors["r_flip_margins"] = margins["cuda"]
    errors["r_flip_margins_cpu"] = margins["cpu"]

    cs, ns = quality_pairs(FEATGEN_PAIRS, np.random.default_rng(20261019))
    lines = []
    for i in range(FEATGEN_PAIRS):
        pair = [tmp / f"c{i}.pcm", tmp / f"n{i}.pcm"]
        for path, x in zip(pair, (cs[i], ns[i])):
            np.trunc(np.clip(x, -32768, 32767)).astype("<i2").tofile(path)
        lines.append(f"{pair[0]} {pair[1]}")
    (tmp / "pairs.txt").write_text("\n".join(lines) + "\n")
    comb.reset_launches()
    t0 = time.perf_counter()
    dispatch("featgen", "--pairs-file", str(tmp / "pairs.txt"), "--out-dir",
             str(tmp / "batch"), "--count", "200", "--batch",
             str(FEATGEN_PAIRS))
    torch.cuda.synchronize()
    seconds["batched"] = time.perf_counter() - t0
    launches["batched"] = launched("featgen_batched", "f32")
    require(launches["batched"] > 0, "batched featgen launched the comb")
    recs = [np.fromfile(tmp / "batch" / f"n{i}.f32", "<f4")
            for i in range(FEATGEN_PAIRS)]
    out = {"launches": launches, "seconds": seconds,
           "records_per_s": {"one_pair": 200 / seconds["one_pair"],
                             "batched": FEATGEN_PAIRS * 200
                             / seconds["batched"]},
           "errors": errors, "card_bounds": FEATGEN_CARD,
           "flip_margin_bound": FEATGEN_FLIP_MARGIN,
           "within_cpu_bounds": {k: errors[k] <= v
                                 for k, v in FEATGEN_CPU.items()},
           "batched_records_finite": all(
               r.size == 200 * 138 and np.isfinite(r).all() for r in recs),
           "card": smi}
    emit("featgen", **out)
    require(errors["period_mismatches"] == 0,
            f"featgen periods: {errors['period_mismatches']} differ")
    for k, bound in FEATGEN_CARD.items():
        require(errors[k] <= bound, f"featgen {k} {errors[k]} > {bound}")
    for (t, b), m in zip(errors["r_flip_at"], errors["r_flip_margins"]):
        require(abs(m) < FEATGEN_FLIP_MARGIN,
                f"featgen r flip at ({t}, {b}) has override margin {m:+.3g}, "
                f"not borderline (< {FEATGEN_FLIP_MARGIN})")
    require(out["batched_records_finite"], "batched records finite, whole")
    return out


def phase_bench(smi: str) -> dict:
    """The port's bench in process at BENCH_SHAPE, f32 and bf16; then
    where a call's time goes at the bench's full shape, BENCH_SPLIT_SHAPE:
    the stages of one call with the bench's weights and signal (the
    second of two runs)."""
    import torch
    from percepnet_tpu_torch import bench
    from percepnet_tpu_torch.ops import comb

    tiers = (("f32", torch.float32), ("bf16", torch.bfloat16))
    out = {"shape": list(BENCH_SHAPE), "card": smi,
           "split_shape": list(BENCH_SPLIT_SHAPE)}
    for tag, dtype in tiers:
        comb.reset_launches()
        res = bench.run(*BENCH_SHAPE, dtype)
        launches = launched(f"bench_{tag}", tag)
        require(launches > 0, f"the {tag} bench launched the comb kernel")
        require(res["value"] > 0, f"the {tag} bench measured a rate")
        print(f"bench {tag} {BENCH_SHAPE[0]} x {BENCH_SHAPE[1]}: peak "
              f"allocated {res['peak_allocated_bytes']} bytes", flush=True)
        print(json.dumps({k: res[k] for k in ("metric", "value", "unit",
                                              "vs_baseline")}), flush=True)
        out[tag] = {**res, "comb_launches": launches}

    for tag, dtype in tiers:
        model, x, kw = bench.inputs(*BENCH_SPLIT_SHAPE, dtype,
                                    torch.device("cuda"))
        for _ in range(2):
            split, _ = stage_seconds(model, x, **kw)
        out[f"split_{tag}"] = split
    emit("bench", **out)
    return out


def phase_comb_paths(rng: np.random.Generator) -> dict:
    """B1 held against its plain version at every shape a driven path
    launched it at: each is one of COMB_CHECK_SHAPES (checked in phase
    comb, at the frontend's n_pad) or is checked here, in both kernels
    and stores, bit for bit."""
    from percepnet_tpu_torch.ops import comb
    require(bool(PATH_SHAPES), "the driven paths launched B1")
    in_comb = {(bsz, t, t * 480 + 5280) for bsz, t in COMB_CHECK_SHAPES}
    shapes, here = {}, {}
    for (entry, bsz, t, n_pad), paths in sorted(PATH_SHAPES.items()):
        name = f"{bsz}x{t}x{n_pad}"
        row = shapes.setdefault(name, {"entries": [], "paths": []})
        row["entries"].append(entry)
        row["paths"] = sorted(set(row["paths"]) | set(paths))
        if (bsz, t, n_pad) in in_comb:
            row["checked_in"] = "comb"
        else:
            if name not in here:
                here[name] = check_comb_case(
                    name, *comb_inputs(bsz, t, rng, n_pad))
            row["checked_in"] = "comb_paths"
    comb.reset_launches()
    emit("comb_paths", shapes=shapes, checked_here=here)
    return {"shapes": shapes, "checked_here": sorted(here)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from percepnet_tpu_torch.bench import card_label
    from percepnet_tpu_torch.io.flat_npz import load_params
    from percepnet_tpu_torch.ops import kernels

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_label()
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
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "cli").mkdir()
        (tmp / "featgen").mkdir()
        cli = phase_cli_enhance(tmp / "cli", rng, smi)
        feat = phase_featgen(tmp / "featgen", smi)
    bench_res = phase_bench(smi)
    paths = phase_comb_paths(rng)

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
    # B1's launches on every path this script drives, each counted from 0
    kernel_lines[0]["launches_by_path"] = {
        "serve": serve["comb_launches"],
        "cli_enhance_batch": cli["launches"]["batch"],
        "cli_enhance_streaming": cli["launches"]["streaming"],
        "featgen_one_pair": feat["launches"]["one_pair"],
        "featgen_batched": feat["launches"]["batched"],
        "bench_f32": bench_res["f32"]["comb_launches"]}
    kernel_lines[1]["launches_by_path"] = {
        "serve_bf16": serve16["comb_bf16_launches"],
        "cli_enhance_bf16": cli["launches"]["bf16"],
        "bench_bf16": bench_res["bf16"]["comb_launches"]}
    # every (B, T) a driven path gave B1, each checked bit for bit
    for line in kernel_lines[:2]:
        line["shapes_checked"] = {
            name: row["checked_in"] for name, row in paths["shapes"].items()
            if any(e.endswith(line["store"]) for e in row["entries"])}
    for line in kernel_lines[2:]:
        line["launches_path"] = v2_path
    print(json.dumps({"kernels": kernel_lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
