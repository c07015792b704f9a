"""Stage-level timing of the enhancement pipeline at the bench shape, on
the card: the counterpart of the JAX package's tools/profile_pipeline.py.

Each stage is timed by utils.profiling.stage_time: the host's wall time
around --iters calls ended by a synchronize, the card's own time in the
same window from torch.profiler (its kernels, copies and fills), the
kernels launched per call and the card's busy share (device / wall).  A
stage that is a Python loop of small kernels (the pitch hysteresis, the
GRU loop) is bound by the host's launch rate: its wall time is far above
its device time, and neither is reported as the other.

Stages, timed separately (nothing overlaps across them: use for ranking,
not exact accounting), on the functions the pipeline runs:
  spectra      framing + window + DFT + band energies (frontend.spectra)
  pitch        stream decimation + whitening + xcorr + search + doubling
    downsample   pitch.downsample_frames_from_stream
    xcorr        pitch.full_xcorr
    wenergy      pitch.forward_window_energies
    decide       yy lookup + pitch_search + doubling precompute, exclusive
                 of xcorr and wenergy (fed them precomputed), as JAX's
    selscan      the per-frame hysteresis (pitch.remove_doubling_scan)
  comb         B1 (the CUDA comb kernel on the card) + DFT + band energy
               + coherence (frontend.comb_spectra)
  model        the PercepNet forward, f32 and bf16
  full         pipeline.enhance_chunk, f32 and bf16

--serving profiles the bf16 serving tier of the frontend stages: bf16 DFT
operands in spectra and B1's bf16 store in comb.  The pitch stages are
f32 in both tiers: the port follows the JAX package's CPU tier, which
ignores its bf16 pitch contractions (features/frontend.py), so no bf16
pitch tier exists.  Random weights from a seeded generator and a
0.05-scaled normal signal.

Usage:
  python -m percepnet_tpu_torch.tools.profile_pipeline [--batch 512]
      [--frames 200] [--iters 8] [--serving] [--json] [--device cpu]

Prints one `{name:12s} {wall_ms:8.1f} ms` line per stage (the JAX tool's
form, which flop_bound --profile-log reads) and, with --json, a last JSON
line with each stage's wall_ms, device_ms, launches, busy_share,
untraced_wall_ms, margin_s (utils.profiling.stage_time) and b1_launches
(B1 launches per call), and the card's name and power limit.  With
--device cpu only wall times are measured.
"""

from __future__ import annotations

import argparse
import copy
import json

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.features import frontend
from percepnet_tpu_torch.models import percepnet as M
from percepnet_tpu_torch.ops import comb, pitch
from percepnet_tpu_torch.tools import device_or_exit
from percepnet_tpu_torch.utils.profiling import stage_time

PITCH_SUB_STAGES = ("downsample", "xcorr", "wenergy", "decide", "selscan")
STAGES = ("spectra", "pitch", *PITCH_SUB_STAGES, "comb", "model f32",
          "model bf16", "full f32", "full bf16")


def _b1_launches() -> int:
    return sum(n for name, n in comb.launches.items()
               if name.startswith("windows_"))


@torch.no_grad()
def run(batch: int, frames: int, iters: int, serving: bool,
        device: torch.device, report=None) -> list[dict]:
    """Every stage of STAGES timed at batch x frames on `device`; one dict
    per stage (stage_time's fields plus name, parent and b1_launches).
    report(row) is called as each stage finishes."""
    bsz, t = batch, frames
    model = M.PercepNet(torch.Generator().manual_seed(0)).to(device)
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(1)
    sig = 0.05 * torch.randn((bsz, t * C.FRAME_SIZE), generator=gen,
                             device=device)
    st = pipeline.init_pipeline_state(bsz, device=device)
    s_pad = torch.cat([st.front.tail, sig], dim=-1)
    p0, g0 = st.front.period, st.front.gain
    rows = []

    def time_stage(name, fn, *args):
        calls = 0

        def counted(*a):
            nonlocal calls
            calls += 1
            return fn(*a)
        before = _b1_launches()
        row = stage_time(counted, *args, iters=iters, device=device)
        row = {"name": name,
               "parent": "pitch" if name in PITCH_SUB_STAGES else None,
               **row, "b1_launches": (_b1_launches() - before) / calls}
        rows.append(row)
        if report:
            report(row)

    def f_spectra(s):
        return frontend.spectra(s, serving=serving)

    def f_downsample(s):
        return pitch.downsample_frames_from_stream(s, t, frontend._PITCH_OFF)

    def f_pitch(s):
        return pitch.pitch_track_ds(f_downsample(s), p0, g0)

    def f_decide(d, xc, w):
        t0, corr = pitch.pitch_search(d, xc, w)
        pre = pitch.remove_doubling_precompute(
            xc, pitch.yy_lookup_table(w), t0)
        return pre, corr

    time_stage("spectra", f_spectra, s_pad)
    time_stage("pitch", f_pitch, s_pad)
    time_stage("downsample", f_downsample, s_pad)
    ds0 = f_downsample(s_pad).reshape(bsz * t, -1)
    time_stage("xcorr", pitch.full_xcorr, ds0)
    time_stage("wenergy", pitch.forward_window_energies, ds0)
    xc0 = pitch.full_xcorr(ds0)
    w0 = pitch.forward_window_energies(ds0)
    time_stage("decide", f_decide, ds0, xc0, w0)
    pre0 = {k: v.reshape(bsz, t, *v.shape[1:])
            for k, v in f_decide(ds0, xc0, w0)[0].items()}
    time_stage("selscan", pitch.remove_doubling_scan, pre0, p0, g0)

    xr, xi, ex = f_spectra(s_pad)
    period = f_pitch(s_pad)["period"]
    time_stage("comb", lambda *a: frontend.comb_spectra(
        *a, serving=serving), s_pad, period, xr[:, :t], xi[:, :t],
        ex[:, :t])

    feats = frontend.analyze_batch(sig, st.front)[0]["features"]
    time_stage("model f32", model, feats,
               M.init_model_state(bsz, device))
    time_stage("model bf16", lambda x, m: model16(
        x, m, compute_dtype=torch.bfloat16), feats,
        M.init_model_state(bsz, device, torch.bfloat16))
    time_stage("full f32", lambda x, s: pipeline.enhance_chunk(
        model, x, s, device=device), sig, st)
    time_stage("full bf16", lambda x, s: pipeline.enhance_chunk(
        model16, x, s, device=device, compute_dtype=torch.bfloat16), sig,
        pipeline.init_pipeline_state(bsz, model_dtype=torch.bfloat16,
                                     device=device))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch.tools.profile_pipeline",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--serving", action="store_true",
                    help="the bf16 serving tier of the frontend stages "
                         "(bf16 DFT operands, B1's bf16 store) instead of "
                         "the f32 parity tier")
    ap.add_argument("--json", action="store_true",
                    help="also print one JSON line with every stage")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_or_exit("profile_pipeline", args.device)

    card = None
    if dev.type == "cuda":
        from percepnet_tpu_torch.bench import card_label
        card = card_label()
    tier = "bf16 serving" if args.serving else "f32"
    print(f"# {card or 'cpu: wall times only'} | {args.batch} x "
          f"{args.frames} frames | frontend tier {tier}; pitch f32 in both "
          f"tiers | {args.iters} calls per stage", flush=True)

    def report(row):
        name = ("  " if row["parent"] else "") + row["name"]
        print(f"{name:12s} {row['wall_ms']:8.1f} ms", flush=True)

    rows = run(args.batch, args.frames, args.iters, args.serving, dev,
               report)
    if args.json:
        print(json.dumps({"tool": "profile_pipeline", "batch": args.batch,
                          "frames": args.frames, "iters": args.iters,
                          "tier": tier, "pitch_tier": "f32",
                          "device": str(dev), "card": card,
                          "stages": rows}), flush=True)


if __name__ == "__main__":
    main()
