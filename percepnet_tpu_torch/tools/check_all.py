"""One-command regression gate for the port: parity + quality: the
counterpart of the JAX package's tools/check_all.py.

Stages (each skippable via --skip), each run as a subprocess:
  parity     tools.check_parity --device cpu   strict 1e-4 gates vs the C
                                               binary's goldens (CPU)
  quality    tools.quality_gate                enhancement beats the noisy
                                               baseline AND bf16 deltas
                                               bounded (|dSTOI| <= .005,
                                               |dSI-SDR| <= .3 dB), on the
                                               card unless --device cpu
  roundtrip  not the port's: its `export` writes the JAX package's bytes
             (tests/test_torch_io.py), so the JAX package's
             tools/roundtrip_check.py covers both packages
  card       not re-run here: chip_smoke.py is the card's check (every
             kernel against its plain version, every path on the card)

A stage that cannot run is a red gate unless the caller skipped it with
--skip; roundtrip and card are listed as skipped with their reasons.

Usage:
  python -m percepnet_tpu_torch.tools.check_all [--weights ckpt.npz]
      [--limit 8] [--log1p] [--skip quality] [--device cpu]

Prints one JSON line and exits 1 unless every stage that ran passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from percepnet_tpu_torch.tools import device_or_exit
from percepnet_tpu_torch.train.checkpoint import latest_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NOT_THE_PORTS = {
    "roundtrip": "the port's export writes the JAX package's bytes "
                 "(tests/test_torch_io.py): run tools/roundtrip_check.py",
    "card": "chip_smoke.py is the card's check: run python3 chip_smoke.py "
            "on the card",
}


def run_stage(name: str, cmd: list[str]) -> dict:
    t0 = time.time()
    print(f"=== {name}: {' '.join(cmd)}", flush=True)
    p = subprocess.run(cmd, cwd=ROOT)
    return {"stage": name, "ok": p.returncode == 0,
            "secs": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch.tools.check_all",
        description=__doc__.splitlines()[0])
    ap.add_argument("--weights",
                    help="trained checkpoint for the quality stage "
                         "(default: newest in work/dns/exp8k)")
    ap.add_argument("--clean-dir", default="work/dns/clean")
    ap.add_argument("--noisy-dir", default="work/dns/noisy")
    ap.add_argument("--dev-filelist",
                    default="work/dns/lists/dev_filelist.txt")
    ap.add_argument("--limit", type=int, default=8,
                    help="held-out pairs for the quality stage")
    ap.add_argument("--log1p", action="store_true",
                    help="weights were trained with log1p_features")
    ap.add_argument("--skip", default="",
                    help="comma-separated stages to skip (parity,quality)")
    ap.add_argument("--device", default=None,
                    help="the quality stage's device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_or_exit("check_all", args.device)
    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    weights = args.weights or latest_checkpoint(
        os.path.join(ROOT, "work", "dns", "exp8k"))
    py = sys.executable
    results, skipped = [], []

    def mark_skipped(name: str, reason: str, *, fatal: bool):
        """A stage that cannot run is a red gate unless the caller asked
        for the skip (or it is not the port's): a green exit that ran only
        parity would mask exactly the rot this tool exists to catch."""
        skipped.append({"stage": name, "reason": reason,
                        "requested": not fatal})
        print(f"=== {name}: skipped ({reason})", flush=True)

    if "parity" in skip:
        mark_skipped("parity", "--skip", fatal=False)
    else:
        results.append(run_stage("parity", [
            py, "-m", "percepnet_tpu_torch.tools.check_parity",
            "--device", "cpu"]))
    have_data = weights and os.path.isdir(os.path.join(ROOT, args.noisy_dir))
    if "quality" in skip:
        mark_skipped("quality", "--skip", fatal=False)
    elif not have_data:
        mark_skipped("quality", "no weights/noisy-dir", fatal=True)
    else:
        cmd = [py, "-m", "percepnet_tpu_torch.tools.quality_gate",
               "--weights", weights, "--clean-dir", args.clean_dir,
               "--noisy-dir", args.noisy_dir, "--limit", str(args.limit),
               "--device", dev.type]
        if args.log1p:
            cmd.append("--log1p")
        if os.path.exists(os.path.join(ROOT, args.dev_filelist)):
            cmd += ["--dev-filelist", args.dev_filelist]
        results.append(run_stage("quality", cmd))
    for name, reason in NOT_THE_PORTS.items():
        mark_skipped(name, reason, fatal=False)

    unrequested = [s for s in skipped if not s["requested"]]
    ok = all(r["ok"] for r in results) and not unrequested
    print(json.dumps({"ok": ok, "weights": weights, "stages": results,
                      "skipped": skipped}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
