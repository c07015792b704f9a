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
           frontend / model / enhance split of one call at 512 x 200;
  train    the training bench (bench.run_train) at the DNS recipe's
           64 x 2000: 1 warm-up and 2 timed steps with remat, then 1 + 1
           without it for its memory; then, on 4 x 100 of featgen's
           records, a step on the card against the port's CPU (loss,
           every gradient leaf, their cosine) and 8 steps' losses, from
           the round-5 checkpoint and from a random init (there with the
           forward products rounded once from f64 on both devices, and
           the f64 gradients of both);
  train_chain  the user's path on the card through the commands:
           featgen (16 pairs, 200 frames) -> split-dataset -> train (8 x
           100, 30 steps) with a dev list; the loss falls, checkpoint-30
           has the JAX package's keys and dtypes, a resumed 31st step
           equals an uninterrupted 31-step run bit for bit, and enhance
           runs with checkpoint-31;
  serve_mesh  StreamingServer(mesh=...) at 64 slots, 8 streams spread
           over the slots, f32 and bf16 with the int16 wire: a 1-shard
           mesh bit for bit against the plain server, a 2-shard mesh on
           the one card (cuda:0 twice: B1 at 32 x 1 per shard per tick)
           within tests/test_parallel.py's mesh bounds; then the
           float-wire 2-shard servers at raw int16 amplitude against the
           plain ones, held to serve_raw's bounds; ticks/s and latency;
  train_dp  data-parallel training at full width on the chain's records:
           (a) `train --distributed` in a real NCCL group of one
           (localhost coordinator) against the same run without
           --distributed, checkpoint-4 bit for bit; (b) two ranks on the
           one card in a gloo group (NCCL refuses two ranks on one
           device), 4 x 100 each from the round-5 checkpoint with log1p
           features, against one rank at 8 x 100 fed both ranks' batches
           in rank order (tests/test_distributed.py's bounds); ms per step
           and the all-reduce's ms (CUDA events) of each;
  profile_stages  (run right after comb) the port's
           tools.profile_pipeline at 512 x 200, f32 and --serving, in
           process, then tools.flop_bound --profile-log on each: per
           stage the wall and device ms, kernels, busy share, B1
           launches and the bound at the H100's peaks; every stage
           present, wall >= device, busy share in (0, 1], B1 once per
           comb-stage call, and the stage bounds summing to flop_bound's
           TOTAL;
  quality_holdout  tools/synth_dns.py's fresh holdout (12 pairs of 20 s,
           seed 999, as a subprocess), then tools.quality_gate --log1p
           --limit 8 on the card, held to the JAX package's result on it
           (artifacts/quality_exp_log1p_30000_fresh_holdout.json): the
           same pairs, noisy baselines within 1e-4 (STOI) and 1e-3 dB,
           f32 within 0.005 and 0.1 dB, bf16 deltas no worse than JAX's
           by more than 0.003 and 0.2 dB (the gate is on that comparison,
           not on the tool's exit code: JAX's own result fails the tool's
           gates on this holdout);
  scaling  tools.scaling_bench at world 1 (one NCCL rank on the card), 3
           steps of 8 x 100: training audio-s/s; the efficiency needs
           several cards;
  comb_paths  B1 bit for bit at every shape a driven path launched it.
Then a `seconds` line (each phase's), a `kernels` line and, last, the
result line.  Any failed check raises and the script exits non-zero
without a result line; so does a machine without a CUDA card.

`python3 chip_smoke.py --dp-worker CONFIG.json` is one rank of train_dp
(b), started by the script itself.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import pathlib
import shutil
import socket
import statistics
import subprocess
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
# training: the DNS recipe's shape (configs/dns_challenge.yaml), timed
# steps after one warm-up; the card-vs-CPU check's shape and its bounds,
# set before the first run on the card (the GRU-amplified card-vs-CPU
# arithmetic, as for g/r): one loss, each gradient leaf against its max
# |g| and the cosine over all leaves, then 8 steps' losses
TRAIN_SHAPE = (64, 2000)
TRAIN_TIMED_STEPS = 2         # 3 until the train phase passed 150 s
TRAIN_CHECK_SHAPE = (4, 100)
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_COS = 1e-4, 1e-2, 0.9999
TRAIN_CHECK_STEPS, TRAIN_STEPS_REL = 8, 1e-3
# the chain: featgen's pairs and frames, then train's batch, length, steps
CHAIN_PAIRS, CHAIN_FRAMES = 16, 200
CHAIN_BATCH, CHAIN_SEQ, CHAIN_STEPS = 8, 100, 30
# serving over a mesh: the 2-shard server against the plain one, of full
# scale (tests/test_parallel.py: f32 2e-4, bf16 5e-3), on the int16 wire
MESH_CAPACITY, MESH_STREAMS = 64, 8
MESH_PCM_TOL = {"f32": 2e-4, "bf16": 5e-3}
# data parallel: global batch, length, steps; two ranks against one
# (tests/test_distributed.py: every checkpoint array, and the losses)
DP_BATCH, DP_SEQ, DP_STEPS, DP_RANKS = 8, 100, 4, 2
DP_RTOL, DP_ATOL, DP_LOSS_ABS = 2e-5, 2e-6, 1e-5
DP_WORKER_TIMEOUT_S = 400
# the port's tools: profile_pipeline's shape and calls per stage
PROFILE_SHAPE, PROFILE_ITERS = (512, 200), 3
# the fresh holdout (artifacts/README.md) and the JAX package's
# tools/quality_gate.py result on it; the port is held to that result:
# baselines (the same audio) to the file's rounding, f32 within the
# bf16 gate's STOI bound and 0.1 dB, and its bf16 deltas no worse than
# JAX's by the slack (ROADMAP A12: JAX's own -0.535 dB is outside the
# gate's 0.3 dB)
HOLDOUT_ARGS = ("--pairs", "12", "--seconds", "20", "--seed", "999",
                "--start-index", "90000")
HOLDOUT_LIMIT = 8
JAX_HOLDOUT = ROOT / "artifacts" / "quality_exp_log1p_30000_fresh_holdout.json"
HOLDOUT_BASELINE_TOL = {"stoi": 1e-4, "si_sdr_db": 1e-3}
HOLDOUT_F32_TOL = {"stoi": 0.005, "si_sdr_db": 0.1}
HOLDOUT_BF16_SLACK = {"stoi": 0.003, "si_sdr_db": 0.2}
# scaling_bench at world 1: per-device batch, length, steps
SCALING_ARGS = ("--per-device-batch", "8", "--seq-len", "100", "--steps",
                "3", "--max-world", "1")


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


def attach_spread(srv, n_streams: int) -> list[int]:
    """n_streams streams on slots spread evenly over the capacity (every
    shard of a mesh serves some): attach every slot, detach the rest."""
    every = [srv.attach() for _ in range(srv.capacity)]
    keep = every[:: srv.capacity // n_streams][:n_streams]
    for sid in set(every) - set(keep):
        srv.detach(sid)
    return keep


def run_ticks(srv, sig: np.ndarray, sids: list[int] | None = None) -> dict:
    """Attach one stream per row of sig (samples in the server's wire
    type), or take `sids`, feed them one frame per tick, then the flush;
    returns the slots, each stream's output, each tick's host time and
    the total."""
    n_streams, n = sig.shape
    n_ticks = n // 480
    if sids is None:
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


def run_tool(main, *argv: str) -> tuple:
    """A tool's main(argv) in this process: (its return value, what it
    printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(list(argv))
    return ret, buf.getvalue()


def dispatch(*argv: str) -> str:
    """`python -m percepnet_tpu_torch <argv>` in this process, on the
    card; returns what it printed."""
    from percepnet_tpu_torch import __main__ as dispatcher
    return run_tool(dispatcher.main, *argv)[1]


def last_json(printed: str) -> dict:
    return json.loads(printed.strip().splitlines()[-1])


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
    out["records"] = [r.reshape(-1, 138) for r in recs]
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


def train_batches(records: list, n_batches: int) -> list:
    """Featgen's records as train.datasets loads them (x30 on columns
    0:68), cut into TRAIN_CHECK_SHAPE batches: [(x, y)] on the CPU."""
    import torch
    from percepnet_tpu_torch import constants as C
    from percepnet_tpu_torch.train import datasets
    bsz, t = TRAIN_CHECK_SHAPE
    chunks = []
    for rec in records:
        for c in range(rec.shape[0] // t):
            chunk = rec[c * t : (c + 1) * t].copy()
            chunk[:, datasets.SCALE_COLS] *= C.FEATURE_SCALE
            chunks.append(chunk)
    require(len(chunks) >= bsz * n_batches, "enough featgen chunks")
    out = []
    for i in range(n_batches):
        x, y = datasets.split_xy(np.stack(chunks[i * bsz : (i + 1) * bsz]))
        out.append((torch.from_numpy(np.ascontiguousarray(x)),
                    torch.from_numpy(np.ascontiguousarray(y))))
    return out


def conv2_preactivation(model, x, dev: str, dtype) -> tuple:
    """conv2's pre-activation [B, T, 512] on `dev` in `dtype` (the
    model's input stack, log1p features) and, for each element, the sum
    of its terms' magnitudes: the ratio is its condition number."""
    import torch
    from percepnet_tpu_torch.models import percepnet as pm
    m = copy.deepcopy(model).to(dev, dtype)
    x = pm.compress_features(x.to(dev)).to(dtype)
    st = pm.init_model_state(x.shape[0], x.device, dtype)
    with torch.no_grad():
        h = torch.relu(x @ m.fc["w"] + m.fc["b"])
        c1, _ = pm._causal_conv(m.conv1, h, st.conv1_mem, torch.relu)
        pre, _ = pm._causal_conv(m.conv2, c1, st.conv2_mem, lambda v: v)
        xp = torch.cat([st.conv2_mem, c1], dim=1).abs()
        w = m.conv2["w"].abs()
        mag = m.conv2["b"].abs() + sum(xp[:, k : k + x.shape[1]] @ w[k]
                                       for k in range(w.shape[0]))
    return pre.cpu().double(), mag.cpu().double()


def phase_train(records: list, smi: str) -> dict:
    """The training step on the card: the --train bench at TRAIN_SHAPE
    with remat (JAX's default) and without it; then, on featgen's
    records with log1p features, a step on the card against the port's
    CPU and TRAIN_CHECK_STEPS steps' losses from two starts.  From the
    round-5 checkpoint (fine-tuning it, as configs/dns_log1p.yaml
    trained it) with the plain f32 step.  From a random init (PercepNet
    seed 0, the reference recipe's start) the input stack's gradient is
    ill-conditioned in f32 on these raw-scale records
    (train/numerics.py): there the plain step is held on its loss and
    cosine, the f64 gradients of both devices against each other, and,
    with every forward product rounded once from f64 on both devices,
    each of TRAIN_CHECK_STEPS steps on the card against the CPU's step
    from the same state (run freely, the two trajectories part after a
    few steps, as any two f32 runs do from this start; printed).  The
    phase prints each f32 gradient's distance from the f64 one and the
    conv2 pre-activation that decides it, on both devices."""
    import torch
    from percepnet_tpu_torch import bench
    from percepnet_tpu_torch.io.flat_npz import load_params
    from percepnet_tpu_torch.models.percepnet import PercepNet
    from percepnet_tpu_torch.train import numerics
    from percepnet_tpu_torch.train import state as ts
    from percepnet_tpu_torch.train.loss import percepnet_loss

    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is off for the f32 training step")
    t0 = time.perf_counter()
    timed = bench.run_train(*TRAIN_SHAPE, steps=TRAIN_TIMED_STEPS)
    no_remat = bench.run_train(*TRAIN_SHAPE, steps=1, remat=False)
    bench_s = time.perf_counter() - t0
    for res in (timed, no_remat):
        print(f"{smi} | train f32 {TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]} | "
              f"remat {'on' if res['remat'] else 'off'} | "
              f"{res['step_ms']:.1f} ms per step | {res['value']} "
              f"audio-s/s | peak allocated {res['peak_allocated_bytes']} "
              f"bytes", flush=True)

    t0 = time.perf_counter()
    batches = train_batches(records, 2)
    names = [f"{layer}/{leaf}" for layer, leaf in ts.LEAVES]

    def exact_if(exact: bool):
        return numerics.ExactProducts() if exact else contextlib.nullcontext()

    def loss_grads(model, dev, dtype=torch.float32, exact=False,
                   batch=0):
        model = copy.deepcopy(model).to(dev, dtype)
        x, y = (v.to(dev) for v in batches[batch])
        with exact_if(exact):
            g, r, _ = model(x, log1p_features=True, remat=True,
                            compute_dtype=dtype)
            loss = percepnet_loss(torch.cat([g, r], dim=-1).to(dtype),
                                  y.to(dtype))
            grads = torch.autograd.grad(loss, ts.parameters(model))
        return loss.item(), [g.cpu().double() for g in grads]

    def compare(want, got) -> dict:
        """Loss rel, each leaf's largest difference over its own max |g|
        (the worst and the three worst), cosine over all leaves."""
        rel = [((b - a).abs().max() / a.abs().max()).item()
               for a, b in zip(want[1], got[1])]
        cos = torch.nn.functional.cosine_similarity(
            torch.cat([g.reshape(-1) for g in want[1]]),
            torch.cat([g.reshape(-1) for g in got[1]]), dim=0).item()
        return {"loss_rel": abs(got[0] - want[0]) / want[0],
                "leaf_rel_max": max(rel), "cosine": cos,
                "worst": sorted(zip(rel, names), reverse=True)[:3]}

    def curve(model, dev, exact=False) -> list:
        opt = ts.make_optimizer(1e-4)
        state = ts.init_train_state(copy.deepcopy(model).to(dev), opt)
        losses = []
        with exact_if(exact):
            for i in range(TRAIN_CHECK_STEPS):
                x, y = (v.to(dev) for v in batches[i % 2])
                losses.append(ts.train_step(state, x, y, opt,
                                            log1p_features=True))
        return [float(v) for v in losses]

    def steps_rel(a, b) -> list:
        return [abs(u - v) / u for u, v in zip(a, b)]

    def steps_from_card_state(model) -> list:
        """TRAIN_CHECK_STEPS exact-products steps on the card; before
        each, the CPU computes the same step from a copy of the card's
        parameters: [compare] per step."""
        opt = ts.make_optimizer(1e-4)
        state = ts.init_train_state(copy.deepcopy(model).to("cuda"), opt)
        params = ts.parameters(state.model)
        out = []
        for i in range(TRAIN_CHECK_STEPS):
            cpu = loss_grads(state.model, "cpu", exact=True, batch=i % 2)
            x, y = (v.to("cuda") for v in batches[i % 2])
            with numerics.ExactProducts():
                loss = ts.loss_fn(state.model, x, y, log1p_features=True)
                grads = torch.autograd.grad(loss, params)
            out.append(compare(cpu, (loss.item(), [g.cpu().double()
                                                   for g in grads])))
            opt.update(params, list(grads), state.opt_state)
        return out

    model_ckpt = load_params(CHECKPOINT)
    ckpt = compare(loss_grads(model_ckpt, "cpu"),
                   loss_grads(model_ckpt, "cuda"))
    ckpt_curves = {dev: curve(model_ckpt, dev) for dev in ("cpu", "cuda")}
    ckpt["steps_loss_rel_max"] = max(steps_rel(ckpt_curves["cpu"],
                                               ckpt_curves["cuda"]))

    rand = PercepNet(torch.Generator().manual_seed(0))
    got = {(dev, tag): loss_grads(rand, dev, dtype, exact)
           for dev in ("cpu", "cuda") for tag, dtype, exact in (
               ("f32", torch.float32, False), ("f64", torch.float64, False),
               ("exact", torch.float32, True))}
    forced = steps_from_card_state(rand)
    free = {dev: curve(rand, dev, exact=True) for dev in ("cpu", "cuda")}
    random = {
        "f32": compare(got["cpu", "f32"], got["cuda", "f32"]),
        "f64": compare(got["cpu", "f64"], got["cuda", "f64"]),
        "exact_steps": {
            "loss_rel": max(c["loss_rel"] for c in forced),
            "leaf_rel_max": max(c["leaf_rel_max"] for c in forced),
            "cosine": min(c["cosine"] for c in forced),
            "per_step": forced},
        "from_f64": {f"{dev}_{tag}": compare(got["cpu", "f64"],
                                             got[dev, tag])["leaf_rel_max"]
                     for dev in ("cpu", "cuda") for tag in ("f32", "exact")},
        "free_running_exact_steps_rel": steps_rel(free["cpu"],
                                                  free["cuda"])}
    # the active (|x| < 9, where f32 tanh is not +-1) conv2 pre-activation
    # with the largest terms for its size, on each device
    pre64, mag = conv2_preactivation(rand, batches[0][0], "cpu",
                                     torch.float64)
    cond = torch.where(pre64.abs() < 9, mag / pre64.abs().clamp_min(1e-3),
                       torch.zeros_like(mag))
    at = np.unravel_index(int(cond.argmax()), tuple(cond.shape))
    random["conv2_worst_element"] = {
        "at": [int(i) for i in at], "sum_abs_terms": mag[at].item(),
        "condition": cond[at].item(), "f64": pre64[at].item(),
        **{dev: conv2_preactivation(rand, batches[0][0], dev,
                                    torch.float32)[0][at].item()
           for dev in ("cpu", "cuda")}}
    check_s = time.perf_counter() - t0

    out = {"shape": list(TRAIN_SHAPE), "card": smi, "bench_s": bench_s,
           "check_s": check_s,
           "remat": {k: timed[k] for k in (
               "step_ms", "value", "peak_allocated_bytes", "flops_per_step",
               "bound_ms", "steps", "loss")},
           "no_remat": {k: no_remat[k] for k in (
               "step_ms", "value", "peak_allocated_bytes", "flops_per_step",
               "bound_ms", "steps")},
           "check_shape": list(TRAIN_CHECK_SHAPE),
           "checkpoint": ckpt, "random_init": random,
           "curves": {"checkpoint": ckpt_curves,
                      "random_init_exact_free_running": free},
           "bounds": {"loss_rel": TRAIN_LOSS_REL,
                      "grad_leaf_rel": TRAIN_GRAD_REL,
                      "grad_cosine": TRAIN_GRAD_COS,
                      "steps_loss_rel": TRAIN_STEPS_REL}}
    emit("train", **out)
    held = {"checkpoint": (ckpt, True, True),
            "random init, f32": (random["f32"], False, False),
            "random init, f64": (random["f64"], True, False),
            f"random init, exact products, {TRAIN_CHECK_STEPS} steps "
            "from the card's state": (random["exact_steps"], True, False)}
    for what, (res, leaves, steps) in held.items():
        require(res["loss_rel"] <= TRAIN_LOSS_REL,
                f"{what}: train loss card vs CPU {res['loss_rel']:.3g} > "
                f"{TRAIN_LOSS_REL}")
        require(res["cosine"] >= TRAIN_GRAD_COS,
                f"{what}: train gradient cosine {res['cosine']:.6f}")
        if leaves:
            require(res["leaf_rel_max"] <= TRAIN_GRAD_REL,
                    f"{what}: train gradient leaf card vs CPU "
                    f"{res['leaf_rel_max']:.3g} > {TRAIN_GRAD_REL}")
        if steps:
            require(res["steps_loss_rel_max"] <= TRAIN_STEPS_REL,
                    f"{what}: {TRAIN_CHECK_STEPS} steps' losses card vs "
                    f"CPU {res['steps_loss_rel_max']:.3g} > "
                    f"{TRAIN_STEPS_REL}")
    return out


def jax_checkpoint_keys() -> dict[str, str]:
    """The keys and dtypes of the JAX package's checkpoint of a PercepNet
    under make_optimizer(): optax's apply_if_finite around adam."""
    from percepnet_tpu_torch.models.percepnet import LAYERS
    keys = {"step": "int32", "opt_state/notfinite_count": "int32",
            "opt_state/last_finite": "bool",
            "opt_state/total_notfinite": "int32",
            "opt_state/inner_state/0/count": "int32"}
    for layer, leaves in LAYERS.items():
        for leaf in leaves:
            for prefix in ("params", "opt_state/inner_state/0/mu",
                           "opt_state/inner_state/0/nu"):
                keys[f"{prefix}/{layer}/{leaf}"] = "float32"
    return keys


def phase_train_chain(tmp: pathlib.Path, smi: str) -> dict:
    """Records to a trained model on the card through the commands:
    featgen -> split-dataset -> train -> resume -> enhance."""
    import torch
    from percepnet_tpu_torch.ops import comb

    cs, ns = quality_pairs(CHAIN_PAIRS, np.random.default_rng(20261020))
    lines = []
    for i in range(CHAIN_PAIRS):
        pair = [tmp / f"c{i}.pcm", tmp / f"n{i}.pcm"]
        for path, x in zip(pair, (cs[i], ns[i])):
            np.trunc(np.clip(x, -32768, 32767)).astype("<i2").tofile(path)
        lines.append(f"{pair[0]} {pair[1]}")
    (tmp / "pairs.txt").write_text("\n".join(lines) + "\n")
    launches, seconds = {}, {}
    comb.reset_launches()
    t0 = time.perf_counter()
    dispatch("featgen", "--pairs-file", str(tmp / "pairs.txt"), "--out-dir",
             str(tmp / "feats"), "--count", str(CHAIN_FRAMES), "--batch",
             str(CHAIN_PAIRS))
    torch.cuda.synchronize()
    seconds["featgen"] = time.perf_counter() - t0
    launches["featgen"] = launched("train_chain_featgen", "f32")
    require(launches["featgen"] > 0, "the chain's featgen launched B1")
    dispatch("split-dataset", str(tmp / "feats"), "--out-dir",
             str(tmp / "lists"))

    def train(out_dir: str, steps: int) -> float:
        comb.reset_launches()
        t0 = time.perf_counter()
        dispatch("train", "--train-filelist",
                 str(tmp / "lists" / "train_filelist.txt"),
                 "--dev-filelist", str(tmp / "lists" / "dev_filelist.txt"),
                 "--out-dir", str(tmp / out_dir), "--batch-size",
                 str(CHAIN_BATCH), "--seq-len", str(CHAIN_SEQ),
                 "--max-steps", str(steps), "--log-interval", "1",
                 "--no-tensorboard")
        return time.perf_counter() - t0

    seconds["train"] = train("exp", CHAIN_STEPS)
    with open(tmp / "exp" / "history.jsonl") as f:
        losses = [json.loads(ln)["loss"] for ln in f]
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    with np.load(tmp / "exp" / f"checkpoint-{CHAIN_STEPS}.npz") as z:
        keys = {k: str(z[k].dtype) for k in z.files}
    want = jax_checkpoint_keys()
    seconds["resume"] = train("exp", CHAIN_STEPS + 1)
    seconds["whole"] = train("whole", CHAIN_STEPS + 1)
    name = f"checkpoint-{CHAIN_STEPS + 1}.npz"
    with np.load(tmp / "exp" / name) as a, np.load(tmp / "whole" / name) as b:
        differ = sorted(k for k in a.files
                        if not np.array_equal(a[k], b[k]))

    comb.reset_launches()
    noisy = tmp / "n0.pcm"
    dispatch("enhance", str(noisy), str(tmp / "enhanced.pcm"), "--weights",
             str(tmp / "exp" / name), "--raw-scale", "--dump-gr",
             str(tmp / "gr.raw"))
    torch.cuda.synchronize()
    launches["enhance"] = launched("train_chain_enhance", "f32")
    require(launches["enhance"] > 0, "the chain's enhance launched B1")
    enhanced = read_pcm(tmp / "enhanced.pcm")
    gr = np.fromfile(tmp / "gr.raw", "<f4")
    n_frames = noisy.stat().st_size // 2 // 480
    out = {"card": smi, "launches": launches, "seconds": seconds,
           "s_per_step": seconds["train"] / CHAIN_STEPS,
           "shape": [CHAIN_BATCH, CHAIN_SEQ], "losses": losses,
           "first_loss": first, "last5_mean": last5,
           "checkpoint_keys": len(keys),
           "keys_as_jax": keys == want,
           "resume_vs_whole_differ": differ,
           "enhanced_samples": int(enhanced.size),
           "gr_finite": bool(np.isfinite(gr).all()),
           "gr_range": [float(gr.min()), float(gr.max())]}
    emit("train_chain", **out)
    require(last5 < first, f"the chain's loss fell: {first} -> {last5}")
    require(keys == want, "checkpoint-30 has the JAX package's keys and "
            f"dtypes: {sorted(set(keys) ^ set(want))[:5]}")
    require(not differ, f"resumed step {CHAIN_STEPS + 1} equals the "
            f"uninterrupted run: {differ[:5]}")
    require(enhanced.size == (n_frames - 1) * 480,
            "enhance wrote the input's frames less the first")
    require(out["gr_finite"] and gr.size == n_frames * 68
            and 0.0 <= gr.min() and gr.max() <= 1.0,
            "the trained model's g/r are finite, in [0, 1]")
    return out


def phase_serve_mesh(model_cpu, sig: np.ndarray) -> dict:
    """StreamingServer(mesh=...) on the card against the plain server,
    each with MESH_STREAMS streams spread over MESH_CAPACITY slots: on
    the int16 wire at /32768 scale, f32 and bf16, the 1-shard mesh bit
    for bit and the 2-shard mesh (cuda:0 twice) within MESH_PCM_TOL of
    full scale; then on the float wire at raw int16 amplitude, the
    2-shard f32 and bf16 servers within serve_raw's bounds."""
    import torch
    from percepnet_tpu_torch import parallel
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.serve import StreamingServer

    model = copy.deepcopy(model_cpu).to("cuda")
    meshes = {"plain": None, "mesh1": ["cuda:0"],
              "mesh2": ["cuda:0", "cuda:0"]}
    pcm16 = np.trunc(np.clip(sig * 32768.0, -32768, 32767)).astype(np.int16)
    raw = sig[:, : 50 * 480] * 32768.0

    def serve(tag, dtype, name, wire_int16, x):
        kw = {"mesh": parallel.make_mesh(meshes[name])} if meshes[name] \
            else {}
        srv = StreamingServer(model, capacity=MESH_CAPACITY,
                              model_dtype=dtype, io_int16=wire_int16,
                              log1p_features=True, **kw)
        sids = attach_spread(srv, MESH_STREAMS)
        comb.reset_launches()
        res = run_ticks(srv, x, sids)
        path = ("serve_mesh" + ("_bf16" if tag == "bf16" else "")
                + ("" if name == "mesh2" else f"_{name}")
                + ("" if wire_int16 else "_raw"))
        res["launches"] = launched(path, tag)
        require(res["launches"] > 0,
                f"{path}: the {tag} server launched B1 ({tag} store)")
        return res

    def compare(a, b) -> dict:
        diff = max(float(np.abs(a["got"][s].astype(np.float64)
                                - b["got"][s]).max()) for s in a["got"])
        peak = max(float(np.abs(b["got"][s].astype(np.float64)).max())
                   for s in b["got"])
        corr = min(float(np.corrcoef(a["got"][s].astype(np.float64),
                                     b["got"][s].astype(np.float64))[0, 1])
                   for s in a["got"])
        return {"max_err": diff, "peak": peak, "min_corr": corr}

    out = {"capacity": MESH_CAPACITY, "streams": MESH_STREAMS,
           "bounds_of_full_scale": MESH_PCM_TOL, "launches": {}}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        runs = {name: serve(tag, dtype, name, True, pcm16)
                for name in meshes}
        sids = runs["plain"]["sids"]
        require(sids == runs["mesh2"]["sids"]
                and {s // (MESH_CAPACITY // 2) for s in sids} == {0, 1},
                "the streams sit in both shards of the 2-shard mesh")
        equal1 = all(np.array_equal(runs["mesh1"]["got"][s],
                                    runs["plain"]["got"][s]) for s in sids)
        c2 = compare(runs["mesh2"], runs["plain"])
        out[tag] = {"mesh1_bit_equal": equal1,
                    "mesh2_vs_plain_lsb": c2,
                    "bound_lsb": MESH_PCM_TOL[tag] * 32768.0,
                    **{name: {"launches": r["launches"], **tick_stats(r)}
                       for name, r in runs.items()}}
        out["launches"][tag] = runs["mesh2"]["launches"]
        rr = {name: serve(tag, dtype, name, False, raw)
              for name in ("plain", "mesh2")}
        out[tag]["raw_scale"] = {
            **compare(rr["mesh2"], rr["plain"]),
            "bound": SERVE_ATOL * 32768.0 if tag == "f32" else SERVE_BF16_LSB,
            "mesh2_ticks_per_s": tick_stats(rr["mesh2"])["ticks_per_s"]}
    emit("serve_mesh", **out)
    for tag in ("f32", "bf16"):
        r = out[tag]
        require(r["mesh1_bit_equal"],
                f"{tag}: the 1-shard mesh server equals the plain one")
        c2 = r["mesh2_vs_plain_lsb"]
        require(c2["peak"] > 0 and c2["max_err"] <= r["bound_lsb"],
                f"{tag}: 2-shard mesh vs plain {c2['max_err']} LSB > "
                f"{r['bound_lsb']:.4g}")
        rs = r["raw_scale"]
        require(rs["peak"] > 0 and rs["max_err"] <= rs["bound"]
                and rs["min_corr"] >= SERVE_BF16_MIN_CORR,
                f"{tag}: raw-scale 2-shard mesh vs plain {rs}")
    return out


def free_port() -> int:
    """A free TCP port on localhost for a process group's coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class AllReduceTimer:
    """Wraps parallel.mesh.all_reduce_mean_ (the training step's gradient
    all-reduce): each call between two CUDA events, and its host time.
    Reads nothing from the card until summary()."""

    def __init__(self):
        import torch
        from percepnet_tpu_torch.parallel import mesh as pm
        self._pm, self._orig = pm, pm.all_reduce_mean_
        self.events, self.host_s, self.floats = [], [], 0

        def timed(tensors):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            self._orig(tensors)
            end.record()
            self.host_s.append(time.perf_counter() - t0)
            self.events.append((start, end))
            self.floats = sum(t.numel() for t in tensors)
        pm.all_reduce_mean_ = timed

    def close(self) -> dict:
        self._pm.all_reduce_mean_ = self._orig
        import torch
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        return {"calls": len(ms), "floats": self.floats,
                "ms_median": statistics.median(ms) if ms else None,
                "host_ms_median": (1e3 * statistics.median(self.host_s)
                                   if ms else None)}


def dp_history(out_dir: pathlib.Path) -> dict:
    """A run's losses and times from its history.jsonl (one record per
    step): the mean ms per step from the loop's start, and the mean over
    the steps after the first (step i ends at i / steps_per_s_i)."""
    with open(out_dir / "history.jsonl") as f:
        hist = [json.loads(ln) for ln in f]
    losses = {r["step"]: r["loss"] for r in hist if "loss" in r}
    first, last = hist[0], hist[-1]
    return {"losses": losses,
            "ms_per_step": 1e3 / last["steps_per_s"],
            "ms_per_step_after_first": 1e3 * (
                last["step"] / last["steps_per_s"]
                - first["step"] / first["steps_per_s"])
            / (last["step"] - first["step"]),
            "train_audio_s_per_s": last["train_audio_s_per_s"]}


def dp_worker(config_path: str) -> int:
    """One rank of train_dp (b): join the gloo group on the card, run the
    train command's body in it once per entry of the config's `runs`
    (under ExactProducts where asked), and write its timings to the
    config's `out`."""
    import torch
    import torch.distributed as dist
    from percepnet_tpu_torch.cli import train as cli_train
    from percepnet_tpu_torch.parallel import mesh as pm
    from percepnet_tpu_torch.train import numerics
    cfg = json.loads(pathlib.Path(config_path).read_text())
    dev = pm.init_distributed(cfg["coordinator"], cfg["world"], cfg["rank"],
                              "cuda", backend="gloo")
    out = {"rank": cfg["rank"], "device": str(dev),
           "backend": dist.get_backend()}
    try:
        for run in cfg["runs"]:
            timer = AllReduceTimer()
            t0 = time.perf_counter()
            with (numerics.ExactProducts() if run["exact"]
                  else contextlib.nullcontext()):
                cli_train.train(
                    cli_train.build_parser().parse_args(run["argv"]), dev)
            torch.cuda.synchronize()
            out[run["name"]] = {"seconds": time.perf_counter() - t0,
                                "all_reduce": timer.close()}
        pm.barrier()
    finally:
        pm.shutdown()
    pathlib.Path(cfg["out"]).write_text(json.dumps(out))
    return 0


def dp_excess(got: pathlib.Path, want: pathlib.Path) -> tuple[str, float]:
    """The checkpoint array and value of the largest |got - want| -
    DP_RTOL |want| (within DP_ATOL is within the bounds); raises unless
    both hold the same keys."""
    with np.load(got) as a, np.load(want) as b:
        require(set(a.files) == set(b.files),
                f"{got} and {want} hold the same arrays")
        over = {}
        for k in b.files:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            over[k] = float(np.max(np.abs(x - y) - DP_RTOL * np.abs(y)))
    return max(over.items(), key=lambda kv: kv[1])


def f64_steps(batches: list, path: pathlib.Path) -> None:
    """DP_STEPS Adam steps in f64 on the card from the round-5 checkpoint
    over `batches` (log1p features, remat), saved as a checkpoint: what
    the f32 runs would give in exact arithmetic."""
    import torch
    from percepnet_tpu_torch.io.flat_npz import load_params
    from percepnet_tpu_torch.train import checkpoint as ckpt
    from percepnet_tpu_torch.train import datasets
    from percepnet_tpu_torch.train import state as ts
    from percepnet_tpu_torch.train.loss import percepnet_loss
    from percepnet_tpu_torch.train.trainer import TrainConfig
    f64 = torch.float64
    opt = ts.make_optimizer(TrainConfig().learning_rate)
    state = ts.init_train_state(load_params(CHECKPOINT).to("cuda", f64), opt)
    params = ts.parameters(state.model)
    for batch in batches:
        x, y = (torch.from_numpy(np.ascontiguousarray(v)).to("cuda", f64)
                for v in datasets.split_xy(batch))
        g, r, _ = state.model(x, log1p_features=True, remat=True,
                              compute_dtype=f64)
        loss = percepnet_loss(torch.cat([g, r], dim=-1), y)
        opt.update(params, list(torch.autograd.grad(loss, params)),
                   state.opt_state)
        state.step.add_(1)
    ckpt.save_checkpoint(str(path), state)


def phase_train_dp(chain: pathlib.Path, smi: str) -> dict:
    """Data-parallel training on the card, on the chain's records (see the
    module docstring).  (a) an NCCL group of one against no group, bit
    for bit.  (b) two gloo ranks on the one card against one rank fed
    both ranks' batches in rank order, from the round-5 checkpoint: held
    to DP_RTOL / DP_ATOL with every forward product rounded once from
    f64 on both sides (train/numerics.py), since the card's f32 GEMMs
    round a row's products differently at batch 4 than at 8; and printed
    in plain f32, beside the plain run's distance from the same steps in
    f64 (the f32 floor)."""
    from percepnet_tpu_torch.cli import train as cli_train
    from percepnet_tpu_torch.parallel import mesh as pm
    from percepnet_tpu_torch.train import datasets
    from percepnet_tpu_torch.train import numerics
    from percepnet_tpu_torch.train.trainer import Trainer, TrainConfig

    # the groups' sockets stay on this host (the workers inherit it)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    filelist = chain / "lists" / "train_filelist.txt"
    tmp = chain / "dp"
    name = f"checkpoint-{DP_STEPS}.npz"
    common = ["--train-filelist", str(filelist), "--seq-len", str(DP_SEQ),
              "--max-steps", str(DP_STEPS), "--log-interval", "1",
              "--no-tensorboard"]

    # (a) a real NCCL group of one against no group
    seen = {}
    init = pm.init_distributed

    def init_seen(*args, **kw):
        import torch.distributed as dist
        dev = init(*args, **kw)
        seen.update(backend=dist.get_backend(), device=str(dev),
                    world=dist.get_world_size())
        return dev
    pm.init_distributed = init_seen
    runs_a, seconds_a = {}, {}
    try:
        for run, extra in (("plain", []), ("nccl", [
                "--distributed", "--coordinator", f"localhost:{free_port()}",
                "--num-processes", "1", "--process-id", "0"])):
            timer = AllReduceTimer()
            t0 = time.perf_counter()
            dispatch("train", *common, "--batch-size", str(DP_BATCH),
                     "--out-dir", str(tmp / run), *extra)
            seconds_a[run] = time.perf_counter() - t0
            runs_a[run] = {**dp_history(tmp / run),
                           "all_reduce": timer.close()}
    finally:
        pm.init_distributed = init
    with np.load(tmp / "plain" / name) as a, \
            np.load(tmp / "nccl" / name) as b:
        differ_a = sorted(k for k in a.files
                          if not np.array_equal(a[k], b[k]))
        keys_a = len(a.files)

    # (b) two gloo ranks on the one card, from the round-5 checkpoint,
    # with exact products, then in plain f32, in one group
    per_rank = DP_BATCH // DP_RANKS
    modes = {"exact": True, "f32": False}
    argv_b = {mode: [*common, "--batch-size", str(per_rank), "--out-dir",
                     str(tmp / f"gloo_{mode}"), "--pretrain",
                     str(CHECKPOINT), "--log1p-features", "--device", "cuda"]
              for mode in modes}
    coordinator = f"localhost:{free_port()}"
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(DP_RANKS):
            config = tmp / f"rank{rank}.json"
            config.write_text(json.dumps({
                "coordinator": coordinator, "world": DP_RANKS,
                "rank": rank, "out": str(tmp / f"rank{rank}.out.json"),
                "runs": [{"name": mode, "exact": exact,
                          "argv": argv_b[mode]}
                         for mode, exact in modes.items()]}))
            log = open(tmp / f"rank{rank}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker",
                 str(config)], cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DP_WORKER_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    seconds_b = time.perf_counter() - t0
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            print((tmp / f"rank{rank}.log").read_text()[-3000:],
                  file=sys.stderr)
        require(p.returncode == 0,
                f"train_dp rank {rank} exited {p.returncode}")
    ranks = [json.loads((tmp / f"rank{r}.out.json").read_text())
             for r in range(DP_RANKS)]

    # one rank at DP_BATCH, fed the ranks' batches in rank order
    files = datasets.read_filelist(str(filelist))
    cfg_rank = TrainConfig(batch_size=per_rank, seq_len=DP_SEQ)
    streams = [cli_train.train_stream(
        datasets.RecordListDataset(files, DP_SEQ, shard_id=r,
                                   num_shards=DP_RANKS),
        files, cfg_rank, r, DP_RANKS, 0) for r in range(DP_RANKS)]
    batches = [np.concatenate([next(s) for s in streams])
               for _ in range(DP_STEPS)]
    one = {}
    for mode, exact in modes.items():
        cfg = TrainConfig(batch_size=DP_BATCH, seq_len=DP_SEQ,
                          train_max_steps=DP_STEPS, log_interval_steps=1,
                          log1p_features=True,
                          out_dir=str(tmp / f"one_{mode}"))
        t1 = time.perf_counter()
        with (numerics.ExactProducts() if exact
              else contextlib.nullcontext()):
            trainer = Trainer(cfg, iter(batches), device="cuda",
                              tensorboard=False)
            trainer.load_pretrained(str(CHECKPOINT))
            trainer.run()
        one[mode] = {"seconds": time.perf_counter() - t1,
                     **dp_history(tmp / f"one_{mode}")}
    f64_steps(batches, tmp / "f64.npz")

    b = {}
    for mode in modes:
        hist = dp_history(tmp / f"gloo_{mode}")
        b[mode] = {
            "worst_excess_over_rtol": list(dp_excess(
                tmp / f"gloo_{mode}" / name, tmp / f"one_{mode}" / name)),
            "loss_max_abs_diff": max(
                abs(hist["losses"][k] - one[mode]["losses"][k])
                for k in one[mode]["losses"]),
            "ms_per_step_after_first": hist["ms_per_step_after_first"],
            "one_rank_ms_per_step_after_first":
                one[mode]["ms_per_step_after_first"],
            "all_reduce": [r[mode]["all_reduce"] for r in ranks],
            "losses": hist["losses"],
            "losses_one_rank": one[mode]["losses"],
            "written": sorted(q.name for q in (tmp / f"gloo_{mode}")
                              .iterdir())}
    floor = list(dp_excess(tmp / "one_f32" / name, tmp / "f64.npz"))
    out = {"card": smi, "shape_global": [DP_BATCH, DP_SEQ],
           "steps": DP_STEPS,
           "a_nccl_world1": {
               "group": seen, "checkpoint_keys": keys_a,
               "differ_from_plain": differ_a, "seconds": seconds_a,
               "ms_per_step_after_first": {
                   k: v["ms_per_step_after_first"]
                   for k, v in runs_a.items()},
               "all_reduce": runs_a["nccl"]["all_reduce"],
               "all_reduce_without_group": runs_a["plain"]["all_reduce"]},
           "b_gloo_two_ranks": {
               "ranks": [{k: r[k] for k in ("rank", "device", "backend")}
                         for r in ranks],
               "per_rank_batch": per_rank, "seconds": seconds_b,
               **b, "f32_one_rank_vs_f64_excess": floor},
           "bounds": {"rtol": DP_RTOL, "atol": DP_ATOL,
                      "loss_abs": DP_LOSS_ABS}}
    emit("train_dp", **out)
    print(f"{smi} | train_dp (a) {seen.get('backend')} world "
          f"{seen.get('world')} x {DP_BATCH} x {DP_SEQ} | "
          f"{runs_a['nccl']['ms_per_step_after_first']:.1f} ms per step "
          f"after the first (plain "
          f"{runs_a['plain']['ms_per_step_after_first']:.1f}) | all-reduce "
          f"{runs_a['nccl']['all_reduce']['ms_median']:.3f} ms", flush=True)
    print(f"{smi} | train_dp (b) {ranks[0]['backend']} {DP_RANKS} ranks x "
          f"{per_rank} x {DP_SEQ}, f32 | "
          f"{b['f32']['ms_per_step_after_first']:.1f} ms per step after the "
          f"first (one rank x {DP_BATCH}: "
          f"{b['f32']['one_rank_ms_per_step_after_first']:.1f}) | "
          f"all-reduce {b['f32']['all_reduce'][0]['ms_median']:.3f} ms",
          flush=True)
    require(seen.get("backend") == "nccl" and seen.get("world") == 1,
            f"(a) ran in an NCCL group of one: {seen}")
    require(runs_a["nccl"]["all_reduce"]["calls"] == DP_STEPS,
            "(a) the NCCL step all-reduced once per step")
    require(not differ_a, f"(a) NCCL world 1 equals the plain run: "
            f"{differ_a[:5]}")
    require(all(r["backend"] == "gloo" and r["device"] == "cuda:0"
                for r in ranks), f"(b) gloo ranks on cuda:0: {ranks}")
    for mode in modes:
        require(b[mode]["written"] == [name, "config.yml", "history.jsonl"],
                f"(b) rank 0 alone wrote: {b[mode]['written']}")
        require(b[mode]["loss_max_abs_diff"] < DP_LOSS_ABS,
                f"(b, {mode}) losses two ranks vs one "
                f"{b[mode]['loss_max_abs_diff']:.3g} >= {DP_LOSS_ABS}")
    worst = b["exact"]["worst_excess_over_rtol"]
    require(worst[1] <= DP_ATOL,
            f"(b, exact products) two ranks vs one: {worst} over rtol "
            f"{DP_RTOL} exceeds atol {DP_ATOL}")
    return out


def phase_profile_stages(smi: str) -> dict:
    """tools.profile_pipeline at PROFILE_SHAPE in both tiers, and
    tools.flop_bound --profile-log on each: one line per tier with every
    stage's times, kernels, busy share, B1 launches, bound and share of
    it.  A stage's bound is flop_bound's row of that name; pitch's is the
    sum of its sub-stages'; model f32 / bf16 take the model row of the f32
    / serving tier and full f32 / bf16 the tier's TOTAL.  It runs early:
    minutes into a process the profiler loses kernels (PERF.md section 6),
    which utils.profiling.stage_time detects and retries."""
    import torch
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.tools import flop_bound, profile_pipeline
    bsz, t = PROFILE_SHAPE
    shape = ("--batch", str(bsz), "--frames", str(t))
    prof, bounds, launches = {}, {}, {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="profile_stages_"))
    for tier, extra in (("f32", ()), ("bf16", ("--serving",))):
        comb.reset_launches()
        _, printed = run_tool(profile_pipeline.main, *shape, "--iters",
                              str(PROFILE_ITERS), "--json", *extra)
        torch.cuda.synchronize()
        launches[tier] = {store: launched(f"profile_stages_{tier}", store)
                          for store in ("f32", "bf16")}
        log = tmp / f"profile_{tier}.log"
        log.write_text(printed)
        prof[tier] = last_json(printed)
        _, printed = run_tool(flop_bound.main, *shape, "--profile-log",
                              str(log), "--json", *extra)
        bounds[tier] = last_json(printed)
    shutil.rmtree(tmp)
    rows = {tier: {r["name"]: r for r in bounds[tier]["stages"]}
            for tier in bounds}
    totals = {tier: bounds[tier]["total_bound_s"] for tier in bounds}
    leaves = ("spectra", *profile_pipeline.PITCH_SUB_STAGES, "comb",
              "model", "synthesis (idft+ola)")
    out = {}
    for tier in ("f32", "bf16"):
        own = rows[tier]

        def stage_bound(name):
            if name == "pitch":
                return sum(own[n]["bound"]
                           for n in profile_pipeline.PITCH_SUB_STAGES)
            if name.startswith("model"):
                return rows[name.split()[1]]["model"]["bound"]
            if name.startswith("full"):
                return totals[name.split()[1]]
            return own[name]["bound"]
        table = []
        for st in prof[tier]["stages"]:
            bound = stage_bound(st["name"]) * 1e3
            table.append({
                "name": st["name"], "wall_ms": st["wall_ms"],
                "device_ms": st["device_ms"], "launches": st["launches"],
                "busy_share": st["busy_share"],
                "untraced_wall_ms": st["untraced_wall_ms"],
                "profiler_margin_s": st["margin_s"],
                "b1_launches": st["b1_launches"], "bound_ms": bound,
                "bound_by": own[st["name"]]["bound_by"]
                if st["name"] in own else None,
                "share_of_bound_wall": bound / st["wall_ms"],
                "share_of_bound_device": bound / st["device_ms"]
                if st["device_ms"] else None})
        out[tier] = {
            "stages": table, "total_bound_ms": totals[tier] * 1e3,
            "sum_of_stage_bounds_ms": sum(own[n]["bound"]
                                          for n in leaves) * 1e3,
            "synthesis_bound_ms": own["synthesis (idft+ola)"]["bound"] * 1e3,
            "speed_of_light_audio_s_per_s":
                bounds[tier]["speed_of_light_audio_s_per_s"],
            "b1_launches": launches[tier]}
        emit("profile_stages", tier=tier, shape=[bsz, t],
             iters=PROFILE_ITERS, card=smi, **out[tier])
    for tier, res in out.items():
        names = [r["name"] for r in res["stages"]]
        require(names == list(profile_pipeline.STAGES),
                f"profile_stages {tier}: every stage, got {names}")
        for r in res["stages"]:
            what = f"profile_stages {tier} {r['name']}"
            require(r["wall_ms"] >= r["device_ms"] > 0,
                    f"{what}: wall {r['wall_ms']} >= device "
                    f"{r['device_ms']} > 0")
            require(0 < r["busy_share"] <= 1,
                    f"{what}: busy share {r['busy_share']}")
            want = 1 if r["name"] == "comb" or r["name"].startswith(
                "full") else 0
            require(r["b1_launches"] == want,
                    f"{what}: B1 {r['b1_launches']} per call, not {want}")
            require(r["bound_ms"] > 0, f"{what}: a bound")
        require(abs(res["sum_of_stage_bounds_ms"] - res["total_bound_ms"])
                <= 1e-9 * res["total_bound_ms"],
                f"profile_stages {tier}: stage bounds sum to flop_bound's "
                f"TOTAL")
    return out


def phase_quality_holdout(tmp: pathlib.Path, smi: str) -> dict:
    """ROADMAP A12: tools/synth_dns.py's fresh holdout (a subprocess),
    then tools.quality_gate on the card in both tiers, held to the JAX
    package's result on the same holdout (JAX_HOLDOUT); every number
    printed beside JAX's before any check."""
    import torch
    from percepnet_tpu_torch.ops import comb
    from percepnet_tpu_torch.tools import quality_gate
    hold = tmp / "holdout"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(ROOT / "tools" / "synth_dns.py"),
                    str(hold), *HOLDOUT_ARGS], check=True, timeout=600,
                   capture_output=True)
    synth_s = time.perf_counter() - t0
    comb.reset_launches()
    t0 = time.perf_counter()
    rc, printed = run_tool(
        quality_gate.main, "--weights", str(CHECKPOINT), "--clean-dir",
        str(hold / "clean"), "--noisy-dir", str(hold / "noisy"), "--log1p",
        "--limit", str(HOLDOUT_LIMIT), "--out-dir", str(tmp / "gate"))
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    launches = {store: launched("quality_holdout", store)
                for store in ("f32", "bf16")}
    port = last_json(printed)
    ref = json.loads(JAX_HOLDOUT.read_text())

    def side_by_side(section, bounds):
        return {k: {"port": port[section][k], "jax": ref[section][k],
                    "diff": port[section][k] - ref[section][k],
                    "bound": bound} for k, bound in bounds.items()}
    out = {
        "pairs": {"port": [r["name"] for r in port["per_pair"]],
                  "jax": [r["name"] for r in ref["per_pair"]]},
        "noisy_baseline": side_by_side("noisy_baseline",
                                       HOLDOUT_BASELINE_TOL),
        "f32": side_by_side("f32", HOLDOUT_F32_TOL),
        "bf16": {k: {"port": port["bf16"][k], "jax": ref["bf16"][k]}
                 for k in ("stoi", "si_sdr_db")},
        "bf16_delta": {k: {"port": port["bf16_delta"][k],
                           "jax": ref["bf16_delta"][k],
                           "port_minus_jax": port["bf16_delta"][k]
                           - ref["bf16_delta"][k], "slack": slack}
                       for k, slack in HOLDOUT_BF16_SLACK.items()},
        "gates": {k: {"port": port[k], "jax": ref[k]}
                  for k in ("enhancement_ok", "bf16_gate_ok")},
        "tool_exit_code": rc, "b1_launches": launches,
        "seconds": {"synth_dns": synth_s, "quality_gate": gate_s},
        "card": smi}
    emit("quality_holdout", **out)
    require(out["pairs"]["port"] == out["pairs"]["jax"],
            "the holdout's selected pairs are JAX's, in its order")
    for section in ("noisy_baseline", "f32"):
        for k, row in out[section].items():
            require(abs(row["diff"]) <= row["bound"],
                    f"holdout {section} {k}: port {row['port']} vs JAX "
                    f"{row['jax']} beyond {row['bound']}")
    for k, row in out["bf16_delta"].items():
        require(row["port_minus_jax"] >= -row["slack"],
                f"holdout bf16 delta {k}: port {row['port']} worse than "
                f"JAX's {row['jax']} by more than {row['slack']}")
    require(rc in (0, 1), f"quality_gate exit code {rc}")
    require(min(launches.values()) > 0,
            f"quality_gate launched B1 in both stores: {launches}")
    return out


def phase_scaling(smi: str) -> dict:
    """tools.scaling_bench at world 1 on the card: one NCCL rank, its
    training audio-s/s.  Weak-scaling efficiency needs several cards."""
    from percepnet_tpu_torch.tools import scaling_bench
    results, printed = run_tool(scaling_bench.main, *SCALING_ARGS)
    out = {"results": results, "card": smi,
           "printed": printed.strip().splitlines(),
           "efficiency": "not measured: it needs several cards, and this "
                         "machine has one"}
    emit("scaling", **out)
    require(len(results) == 1 and results[0]["devices"] == 1
            and results[0]["backend"] == "nccl"
            and results[0]["audio_s_per_s"] > 0,
            f"scaling_bench at world 1: {results}")
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

    seconds = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        res = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return res

    rng = np.random.default_rng(20261017)
    comb_res = timed("comb", phase_comb, rng)
    stages = timed("profile_stages", phase_profile_stages, smi)
    model_cpu = load_params(CHECKPOINT)
    timed("batch", phase_batch, model_cpu, batch_input(16, 200, rng))
    serve_sig = batch_input(8, 100, rng)
    timed("batch_bf16", phase_batch_bf16, model_cpu, *quality_pairs(
        16, np.random.default_rng(20261018)))
    serve = timed("serve", phase_serve, model_cpu, serve_sig)
    serve16 = timed("serve_bf16", phase_serve_bf16, model_cpu, serve_sig,
                    serve)
    timed("serve_raw", phase_serve_raw, model_cpu, serve_sig[:, : 50 * 480])
    timed("profile", phase_profile, model_cpu, serve_sig,
          serve["tick_ms_median"])
    mesh = timed("serve_mesh", phase_serve_mesh, model_cpu, serve_sig)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for sub in ("cli", "featgen", "chain", "tools"):
            (tmp / sub).mkdir()
        cli = timed("cli_enhance", phase_cli_enhance, tmp / "cli", rng, smi)
        feat = timed("featgen", phase_featgen, tmp / "featgen", smi)
        bench_res = timed("bench", phase_bench, smi)
        timed("train", phase_train, feat["records"], smi)
        chain = timed("train_chain", phase_train_chain, tmp / "chain", smi)
        timed("train_dp", phase_train_dp, tmp / "chain", smi)
        holdout = timed("quality_holdout", phase_quality_holdout,
                        tmp / "tools", smi)
        timed("scaling", phase_scaling, smi)
    paths = timed("comb_paths", phase_comb_paths, rng)
    emit("seconds", **seconds)

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
        "bench_f32": bench_res["f32"]["comb_launches"],
        "train_chain_featgen": chain["launches"]["featgen"],
        "train_chain_enhance": chain["launches"]["enhance"],
        "serve_mesh": mesh["launches"]["f32"],
        "profile_stages": sum(stages[tier]["b1_launches"]["f32"]
                              for tier in stages),
        "quality_holdout": holdout["b1_launches"]["f32"]}
    kernel_lines[1]["launches_by_path"] = {
        "serve_bf16": serve16["comb_bf16_launches"],
        "serve_mesh_bf16": mesh["launches"]["bf16"],
        "cli_enhance_bf16": cli["launches"]["bf16"],
        "bench_bf16": bench_res["bf16"]["comb_launches"],
        "profile_stages": sum(stages[tier]["b1_launches"]["bf16"]
                              for tier in stages),
        "quality_holdout": holdout["b1_launches"]["bf16"]}
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
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    sys.exit(main())
