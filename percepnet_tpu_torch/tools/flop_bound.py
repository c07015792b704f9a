"""Roofline / speed-of-light analysis of the enhancement pipeline at the
H100's peaks: the counterpart of the JAX package's tools/flop_bound.py.

For each stage (the stage cut of profile_pipeline) this computes the two
lower bounds on its time at the bench shape and the audio throughput
("speed of light") they imply:

  t_flop = FLOPs / the peak of the arithmetic the port runs there
  t_mem  = min bytes / 3.35 TB/s  (each input read once, each output
           written once)

Peaks: an H100 SXM's, from NVIDIA's data sheet (dense, at its 700 W power
limit; utils/profiling): 67 TFLOP/s f32 outside the tensor cores, 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s.  Which applies is what the
port runs: TF32 is off (the package's __init__), so every f32 matmul and
convolution bounds at 67; in the bf16 serving tier the DFT operands are
bf16 but the product is an f32 GEMM on the rounded values (ops/dft.py),
so the spectra, comb and synthesis stay at 67; only the bf16 model's
matmuls run on the tensor cores at 989.  Each row names its peak.

FLOPs of the stages without a time loop come from
torch.utils.flop_counter.FlopCounterMode around the functions the
pipeline runs, on the CPU at COUNT_BATCH streams and scaled linearly to
--batch (every product's rows are streams x frames).  The counter counts
matmuls and convolutions, not elementwise work, so a stage of only
elementwise work (wenergy's prefix sums, the hysteresis) counts 0 FLOPs
and is bound by its bytes.  B1 is launched through ctypes, which the
counter cannot see: the comb windows are counted analytically, 7
multiply-adds and 1 window multiply per output sample.  The model is
counted from its layer dimensions, 2 FLOPs per weight per frame, which
reproduces the parameter count within 1% (the JAX tool's check).  The JAX
tool's "comb ISA floor" counted a TPU's vector-register rotates; on this
card the comb's floor is its byte bound (PERF.md section 6).

With --profile-log (profile_pipeline's output: its text lines or its
--json line) the measured stage times are merged in, with the efficiency
bound / measured against the wall time and, from the JSON line, against
the card's own time.

Usage:
  python -m percepnet_tpu_torch.tools.flop_bound [--batch 512]
      [--frames 200] [--serving] [--profile-log profile.log] [--json]
      [--device cpu]

The counting runs on the host; on a card the output names the card and
its power limit, whose peaks the bounds assume.
"""

from __future__ import annotations

import argparse
import json
import math
import re

import torch
from torch.utils.flop_counter import FlopCounterMode

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.features import frontend
from percepnet_tpu_torch.models.percepnet import LAYERS, weight_count
from percepnet_tpu_torch.ops import pitch
from percepnet_tpu_torch.tools import device_or_exit
from percepnet_tpu_torch.utils.profiling import (BF16_FLOPS_PER_S,
                                                 F32_FLOPS_PER_S,
                                                 HBM_BYTES_PER_S)

COUNT_BATCH = 1                 # streams the counted stages run at
COMB_FLOPS_PER_SAMPLE = 7 * 2 + 1
PEAKS = {"f32": F32_FLOPS_PER_S, "bf16": BF16_FLOPS_PER_S}
_LINE = re.compile(r"^\s*(.+?)\s+([0-9.]+)\s+ms\s*$")


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_bytes(x) for x in tree)
    return 0


def _counted(fn, *args) -> tuple[float, int, object]:
    """(FLOPs, input + output bytes, output) of fn(*args)."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return float(counter.get_total_flops()), _bytes(args) + _bytes(out), out


@torch.no_grad()
def counted_stages(batch: int, frames: int, serving: bool) -> list[dict]:
    """FLOPs and min bytes of the stages without a time loop, counted on
    the CPU at `batch` streams x `frames` (a seeded 0.05-scaled signal;
    the counts do not depend on the values)."""
    bsz, t = batch, frames
    gen = torch.Generator().manual_seed(1)
    sig = 0.05 * torch.randn((bsz, t * C.FRAME_SIZE), generator=gen)
    st = pipeline.init_pipeline_state(bsz, device="cpu")
    s_pad = torch.cat([st.front.tail, sig], dim=-1)
    rows = []

    def add(name, flops, io_bytes, how="flop_counter"):
        rows.append({"name": name, "flops": flops, "bytes": io_bytes,
                     "how": how})

    flops, nbytes, (xr, xi, ex) = _counted(
        lambda s: frontend.spectra(s, serving=serving), s_pad)
    add("spectra", flops, nbytes)
    flops, nbytes, ds = _counted(
        lambda s: pitch.downsample_frames_from_stream(
            s, t, frontend._PITCH_OFF), s_pad)
    add("downsample", flops, nbytes)
    ds0 = ds.reshape(bsz * t, -1)
    flops, nbytes, xc = _counted(pitch.full_xcorr, ds0)
    add("xcorr", flops, nbytes)
    flops, nbytes, w = _counted(pitch.forward_window_energies, ds0)
    add("wenergy", flops, nbytes)

    def decide(d, xc, w):
        t0, corr = pitch.pitch_search(d, xc, w)
        return pitch.remove_doubling_precompute(
            xc, pitch.yy_lookup_table(w), t0), corr
    flops, nbytes, (pre, _) = _counted(decide, ds0, xc, w)
    add("decide", flops, nbytes)
    pre = {k: v.reshape(bsz, t, *v.shape[1:]) for k, v in pre.items()}
    flops, nbytes, _ = _counted(pitch.remove_doubling_scan, pre,
                                st.front.period, st.front.gain)
    add("selscan", flops, nbytes)
    period = torch.full((bsz, t), 200, dtype=torch.int32)
    flops, nbytes, _ = _counted(
        lambda *a: frontend.comb_spectra(*a, serving=serving), s_pad,
        period, xr[:, :t], xi[:, :t], ex[:, :t])
    add("comb", flops + COMB_FLOPS_PER_SAMPLE * bsz * t * C.WINDOW_SIZE,
        nbytes, "flop_counter + analytic comb windows")
    return rows


def stages(batch: int, frames: int, serving: bool) -> list[dict]:
    """Every stage's flops, bytes, how it was counted and its peak, at
    batch x frames: the counted stages scaled from COUNT_BATCH, then the
    analytic model and synthesis rows."""
    bsz, t = batch, frames
    scale = bsz / COUNT_BATCH
    rows = [dict(r, flops=r["flops"] * scale, bytes=r["bytes"] * scale,
                 peak="f32")
            for r in counted_stages(COUNT_BATCH, t, serving)]
    # multiply-adds per stream per frame; with the biases they are the
    # parameter count, which they must be within 1% of (the JAX tool's
    # check of the analytic count)
    macs = weight_count()
    n_params = sum(math.prod(s) for leaves in LAYERS.values()
                   for s in leaves.values())
    if abs(macs - n_params) / n_params >= 0.01:
        raise AssertionError(f"model MACs {macs} vs parameters {n_params}")
    wbytes = n_params * (2 if serving else 4)
    feat_bytes = bsz * t * C.NB_FEATURES * 4
    out_bytes = bsz * t * 2 * C.NB_BANDS * 4      # the heads are f32
    model_peak = "bf16" if serving else "f32"
    rows.append({"name": "model", "flops": 2.0 * macs * bsz * t,
                 "bytes": wbytes + feat_bytes + out_bytes,
                 "how": "analytic", "peak": model_peak})
    # the weights read from device memory every frame: a bound that
    # holds if they do not stay in the 50 MB L2 across frames (not in
    # the total)
    rows.append({"name": "model (weights re-streamed)",
                 "flops": 2.0 * macs * bsz * t,
                 "bytes": wbytes * t + feat_bytes + out_bytes,
                 "how": "analytic", "peak": model_peak})
    rows.append({"name": "synthesis (idft+ola)",
                 "flops": 2.0 * (2 * C.FREQ_SIZE) * C.WINDOW_SIZE * bsz * t,
                 "bytes": (bsz * t * 2 * C.FREQ_SIZE
                           + bsz * (t + 1) * C.FRAME_SIZE) * 4,
                 "how": "analytic", "peak": "f32"})
    return rows


def read_profile(path: str) -> dict[str, dict]:
    """{stage: {"wall_s", "device_s"}} from profile_pipeline's output: the
    text lines (wall only) and, where present, its --json line."""
    measured: dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                data = json.loads(line)
                for row in data.get("stages", ()):
                    dev = row.get("device_ms")
                    measured[row["name"]] = {
                        "wall_s": row["wall_ms"] / 1e3,
                        "device_s": None if dev is None else dev / 1e3}
                continue
            m = _LINE.match(line)
            if m:
                measured.setdefault(m.group(1).strip(), {
                    "wall_s": float(m.group(2)) / 1e3, "device_s": None})
    return measured


def analyze(batch: int, frames: int, serving: bool,
            measured: dict | None = None) -> dict:
    """The tool's JSON result: every stage with t_flop, t_mem, bound,
    bound_by and speed of light, merged with `measured` (read_profile)."""
    audio_s = batch * frames * C.FRAME_SIZE / C.SAMPLE_RATE
    rows, total = [], 0.0
    for s in stages(batch, frames, serving):
        t_flop = s["flops"] / PEAKS[s["peak"]]
        t_mem = s["bytes"] / HBM_BYTES_PER_S
        bound = max(t_flop, t_mem)
        in_total = "re-streamed" not in s["name"]
        if in_total:
            total += bound
        row = dict(s, peak_flops_per_s=PEAKS[s["peak"]], t_flop=t_flop,
                   t_mem=t_mem, bound=bound,
                   bound_by="operations" if t_flop > t_mem else "bytes",
                   light=audio_s / bound, in_total=in_total)
        key = s["name"].split(" (")[0]
        if key == "model":
            key = "model bf16" if serving else "model f32"
        meas = (measured or {}).get(key)
        if meas:
            row.update(measured=meas["wall_s"], eff=bound / meas["wall_s"])
            if meas["device_s"]:
                row.update(measured_device=meas["device_s"],
                           eff_device=bound / meas["device_s"])
        rows.append(row)
    return {"tool": "flop_bound", "batch": batch, "frames": frames,
            "tier": "bf16 serving" if serving else "f32",
            "peaks": {"f32_flops_per_s": F32_FLOPS_PER_S,
                      "bf16_flops_per_s": BF16_FLOPS_PER_S,
                      "hbm_bytes_per_s": HBM_BYTES_PER_S},
            "audio_s_per_chunk": audio_s, "total_bound_s": total,
            "speed_of_light_audio_s_per_s": audio_s / total,
            "stages": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch.tools.flop_bound",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--serving", action="store_true",
                    help="the bf16 serving tier (the bf16 model on the "
                         "tensor cores) instead of the f32 tier")
    ap.add_argument("--profile-log",
                    help="profile_pipeline output to merge in")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default: names the card whose peaks the "
                         "bounds assume) or cpu")
    args = ap.parse_args(argv)
    dev = device_or_exit("flop_bound", args.device)
    card = None
    if dev.type == "cuda":
        from percepnet_tpu_torch.bench import card_label
        card = card_label()

    measured = read_profile(args.profile_log) if args.profile_log else {}
    res = analyze(args.batch, args.frames, args.serving, measured)
    res["card"] = card
    print(f"# shape batch={args.batch} frames={args.frames} "
          f"({res['audio_s_per_chunk']:.0f} audio-s/chunk), tier "
          f"{res['tier']}; peaks (H100 SXM data sheet, 700 W): f32 "
          f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, bf16 tensor cores "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s, "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; card: "
          f"{card or 'none asked (host analysis)'}")
    hdr = (f"{'stage':28s} {'peak':>5s} {'GFLOP':>8s} {'t_flop':>8s} "
           f"{'minGB':>7s} {'t_mem':>8s} {'bound':>8s} {'light au/s':>10s}")
    if measured:
        hdr += f" {'meas':>8s} {'eff':>5s} {'device':>8s} {'eff_d':>5s}"
    print(hdr)
    for row in res["stages"]:
        name = row["name"] + ("*" if row["how"] == "analytic" else "")
        line = (f"{name:28s} {row['peak']:>5s} {row['flops'] / 1e9:8.2f} "
                f"{row['t_flop'] * 1e3:6.3f}ms {row['bytes'] / 1e9:7.3f} "
                f"{row['t_mem'] * 1e3:6.3f}ms {row['bound'] * 1e3:6.3f}ms "
                f"{row['light']:10.0f}")
        if measured:
            if "measured" in row:
                line += (f" {row['measured'] * 1e3:6.2f}ms "
                         f"{row['eff']:5.1%}")
            else:
                line += f" {'-':>8s} {'-':>5s}"
            if "measured_device" in row:
                line += (f" {row['measured_device'] * 1e3:6.2f}ms "
                         f"{row['eff_device']:5.1%}")
        print(line)
    total = res["total_bound_s"]
    print(f"{'TOTAL (sum of bounds)':28s} {'':5s} {'':8s} {'':8s} {'':7s} "
          f"{'':8s} {total * 1e3:6.3f}ms "
          f"{res['speed_of_light_audio_s_per_s']:10.0f}")
    print("* analytic count; the other rows count matmul and convolution "
          "FLOPs (FlopCounterMode), not elementwise work; stages are timed "
          "apart, so cross-stage fusion is not modeled; min bytes assume "
          "each input read once and each output written once.")
    if args.json:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
