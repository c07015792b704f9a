"""Objective evaluation: STOI / SI-SDR / SNR of enhanced vs clean PCM.

Usage:
  python -m percepnet_tpu_torch evaluate clean.pcm enhanced.pcm
  python -m percepnet_tpu_torch evaluate --pairs-file pairs.txt [--json]

A pairs file has lines `clean.pcm enhanced.pcm`.  Prints per-pair metrics
and the mean: STOI, SI-SDR, SNR, and a P.862-structured `pesq_like_uncal`
score (utils.pesq: NOT validated against ITU conformance vectors and NOT
P.862 MOS-LQO, so a relative measure only).  The metrics are numpy/scipy
on the host; --device is resolved as by every command (the card unless
`cpu`), so the command surface fails alike without a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.io.pcm import read_pcm16
from percepnet_tpu_torch.ops.dispatch import resolve_device
from percepnet_tpu_torch.utils import metrics
from percepnet_tpu_torch.utils.pesq import pesq_like

METRICS = ("stoi", "si_sdr_db", "snr_db", "pesq_like_uncal")


def evaluate_pair(clean_path: str, enhanced_path: str,
                  align: bool = True) -> dict:
    clean = read_pcm16(clean_path, normalize=True)
    enh = read_pcm16(enhanced_path, normalize=True)
    if align:
        # compensate the enhancer's algorithmic delay: the output LAGS the
        # input by lookahead+1 frames minus the dropped first frame
        # (enh[t] enhances clean[t - FRAME_LOOKAHEAD*480]), so leading
        # samples are dropped from the ENHANCED side
        d = C.FRAME_LOOKAHEAD * C.FRAME_SIZE
        best, best_sdr = 0, -1e9
        for cand in (0, d, d + C.FRAME_SIZE):
            n = min(len(clean), len(enh) - cand)
            if n <= 0:
                continue
            sdr = metrics.si_sdr_db(clean[:n], enh[cand : cand + n])
            if sdr > best_sdr:
                best, best_sdr = cand, sdr
        enh = enh[best:]
    n = min(len(clean), len(enh))
    clean, enh = clean[:n], enh[:n]
    return {
        "stoi": round(metrics.stoi(clean, enh), 4),
        "si_sdr_db": round(metrics.si_sdr_db(clean, enh), 2),
        "snr_db": round(metrics.snr_db(clean, enh), 2),
        "pesq_like_uncal": round(pesq_like(clean, enh), 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch evaluate",
        description=__doc__.splitlines()[0])
    ap.add_argument("pcm", nargs="*", help="clean.pcm enhanced.pcm")
    ap.add_argument("--pairs-file")
    ap.add_argument("--no-align", action="store_true",
                    help="skip delay-compensating alignment")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.pairs_file:
        with open(args.pairs_file) as f:
            pairs = [tuple(ln.split()[:2]) for ln in f if ln.strip()]
    elif len(args.pcm) == 2:
        pairs = [(args.pcm[0], args.pcm[1])]
    else:
        ap.error("expected: clean.pcm enhanced.pcm (or --pairs-file)")
    resolve_device(args.device)

    rows = []
    for clean_p, enh_p in pairs:
        m = evaluate_pair(clean_p, enh_p, align=not args.no_align)
        m["pair"] = f"{clean_p} {enh_p}"
        rows.append(m)
        if not args.json:
            print(f"{enh_p}: stoi {m['stoi']} si_sdr {m['si_sdr_db']} dB "
                  f"snr {m['snr_db']} dB pesq_like* {m['pesq_like_uncal']} "
                  f"(*uncalibrated, not P.862 MOS)")
    summary = {k: round(float(np.nanmean([r[k] for r in rows])), 4)
               for k in METRICS}
    if args.json:
        print(json.dumps({"pairs": rows, "mean": summary}))
    else:
        print(f"mean: {summary}")


if __name__ == "__main__":
    main()
