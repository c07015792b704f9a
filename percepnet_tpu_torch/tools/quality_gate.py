"""Quality evaluation + bf16 serving gate for a trained checkpoint, on the
card: the counterpart of the JAX package's tools/quality_gate.py, with its
flags, its JSON keys and its exit rule.

Enhances held-out noisy files with the given weights in f32 AND the bf16
serving tier (cli.enhance.enhance_files, raw_scale=True), then reports
STOI / SI-SDR against the clean references (cli.evaluate.evaluate_pair):

  * enhancement gain: enhanced vs the noisy baseline (must improve),
  * bf16 gate: bf16-vs-f32 quality deltas must stay within the stated
    bounds (|dSTOI| <= 0.005, |dSI-SDR| <= 0.3 dB) for bf16 to be an
    acceptable serving default.

Usage:
  python -m percepnet_tpu_torch.tools.quality_gate --weights ckpt.npz \\
      --clean-dir work/dns/clean --noisy-dir work/dns/noisy \\
      [--dev-filelist work/dns/lists/dev_filelist.txt] [--limit 16] \\
      [--log1p] [--skip-bf16] [--order snr|list] [--out-dir DIR] \\
      [--device cpu]

Prints one JSON line with the full metric table (the card's name and
power limit go to stderr) and exits 1 if enhancement fails to beat the
noisy baseline or the bf16 gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from percepnet_tpu_torch.cli.enhance import enhance_files, load_params
from percepnet_tpu_torch.cli.evaluate import METRICS, evaluate_pair
from percepnet_tpu_torch.tools import device_or_exit

DSTOI_GATE, DSISDR_GATE = 0.005, 0.3


def _read(path: str) -> np.ndarray:
    return np.fromfile(path, "<i2").astype(np.float32)


def select_pairs(clean_dir: str, noisy_dir: str, names: list[str],
                 order: str, limit: int) -> list[str]:
    """The evaluated pair names: `names` (filelist order), or with
    order='snr' the lowest-baseline-SNR ones first, cut to `limit`, then
    without the silent-clean pairs (their SI-SDR is -inf)."""
    if order == "snr":
        def baseline_snr(n):
            c = _read(os.path.join(clean_dir, n + ".pcm"))
            y = _read(os.path.join(noisy_dir, n + ".pcm"))
            m = min(len(c), len(y))
            if float(np.sum(c[:m] ** 2)) < 1.0:
                # a silent clean reference carries no enhancement
                # information and would sort FIRST (SNR -> -inf)
                return float("inf")
            den = float(np.sum((y[:m] - c[:m]) ** 2)) + 1e-9
            return 10.0 * np.log10(float(np.sum(c[:m] ** 2)) / den + 1e-12)
        names = sorted(names, key=baseline_snr)
    names = names[:limit]

    def clean_energy(n):
        c = np.fromfile(os.path.join(clean_dir, n + ".pcm"), "<i2")
        return float(np.sum(c.astype(np.float64) ** 2))
    kept = [n for n in names if clean_energy(n) >= 1.0]
    if len(kept) < len(names):
        print(f"quality_gate: dropped {len(names) - len(kept)} "
              f"silent-clean pair(s)", file=sys.stderr)
    return kept


def _mean(rows: list[dict]) -> dict:
    # nanmean: pesq_like is undefined (NaN) on a silent reference; one
    # degenerate pair must not NaN the corpus mean
    return {k: round(float(np.nanmean([r[k] for r in rows])), 4)
            for k in METRICS}


def _json_safe(x):
    """NaN -> null so the emitted line stays strict JSON."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch.tools.quality_gate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--clean-dir", required=True)
    ap.add_argument("--noisy-dir", required=True)
    ap.add_argument("--dev-filelist",
                    help="feature filelist whose basenames select the "
                         "held-out pairs (recipe layout); default: all "
                         "pairs in --noisy-dir")
    ap.add_argument("--limit", type=int, default=16)
    ap.add_argument("--out-dir", help="keep enhanced PCM here")
    ap.add_argument("--skip-bf16", action="store_true")
    ap.add_argument("--log1p", action="store_true",
                    help="checkpoint was trained with log1p_features")
    ap.add_argument("--order", choices=("snr", "list"), default="snr",
                    help="'snr' (default) evaluates the LOWEST-baseline-SNR "
                         "pairs of the dev set: the enhancement-improves "
                         "criterion is only meaningful where there is noise "
                         "to remove; 'list' keeps the filelist order")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_or_exit("quality_gate", args.device)

    if args.dev_filelist:
        with open(args.dev_filelist) as f:
            names = [os.path.splitext(os.path.basename(ln.strip()))[0]
                     for ln in f if ln.strip()]
    else:
        names = [os.path.splitext(n)[0]
                 for n in sorted(os.listdir(args.noisy_dir))]
    names = select_pairs(args.clean_dir, args.noisy_dir, names, args.order,
                         args.limit)
    cleans = [os.path.join(args.clean_dir, n + ".pcm") for n in names]
    noisys = [os.path.join(args.noisy_dir, n + ".pcm") for n in names]
    if dev.type == "cuda":
        from percepnet_tpu_torch.bench import card_label
        print(f"quality_gate: on {card_label()}", file=sys.stderr)

    model = load_params(args.weights)
    out_root = args.out_dir or tempfile.mkdtemp(prefix="quality_gate_")

    def run_mode(tag, model_dtype):
        outs = [os.path.join(out_root, tag, n + ".pcm") for n in names]
        os.makedirs(os.path.join(out_root, tag), exist_ok=True)
        # raw_scale: the checkpoint was trained on featgen-scale features
        # (NORM_RATIO=1); see enhance_files for the reference's
        # inference/training scale mismatch
        enhance_files(model, noisys, outs, model_dtype=model_dtype,
                      raw_scale=True, log1p_features=args.log1p, device=dev)
        rows = [evaluate_pair(c, o) for c, o in zip(cleans, outs)]
        return _mean(rows), rows

    baseline = [evaluate_pair(c, n, align=False)
                for c, n in zip(cleans, noisys)]
    f32_mean, f32_rows = run_mode("f32", None)
    report = {
        "pairs": len(names),
        "noisy_baseline": _mean(baseline),
        "f32": f32_mean,
        "per_pair": [
            {"name": nm,
             "noisy_si_sdr_db": b["si_sdr_db"], "si_sdr_db": r["si_sdr_db"],
             "noisy_stoi": b["stoi"], "stoi": r["stoi"]}
            for nm, b, r in zip(names, baseline, f32_rows)],
    }
    if not args.skip_bf16:
        report["bf16"] = run_mode("bf16", torch.bfloat16)[0]
        report["bf16_delta"] = {
            "stoi": round(report["bf16"]["stoi"] - report["f32"]["stoi"], 4),
            "si_sdr_db": round(report["bf16"]["si_sdr_db"]
                               - report["f32"]["si_sdr_db"], 3)}
        report["bf16_gate_ok"] = bool(
            abs(report["bf16_delta"]["stoi"]) <= DSTOI_GATE
            and abs(report["bf16_delta"]["si_sdr_db"]) <= DSISDR_GATE)

    report["enhancement_ok"] = bool(
        report["f32"]["stoi"] >= report["noisy_baseline"]["stoi"]
        and report["f32"]["si_sdr_db"] > report["noisy_baseline"]["si_sdr_db"])

    print(json.dumps(_json_safe(report), allow_nan=False), flush=True)
    ok = report["enhancement_ok"] and report.get("bf16_gate_ok", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
