"""Strict CPU parity check of the port against the reference binaries: the
counterpart of the JAX package's tools/check_parity.py.

Runs the north-star gates on tests/goldens/{featgen,nn}.npz through the
port, in f32 on the host CPU, where the gates are defined:
  oracle PCM (featgen's labels through enhance_spectra) vs `percepNet`'s
    test_output, < 1e-4 normalized;
  g/r of the C binary's weights with its tansig/sigmoid tables vs
    `percepNet_run`'s inference, < 1e-5;
  the NN-enhanced PCM vs `percepNet_run`'s output, < 1e-4 normalized.

  python -m percepnet_tpu_torch.tools.check_parity --device cpu

The gates hold on the CPU only: the card's GEMMs round differently and
the GRU recurrence carries that to ~1e-3 in g/r (PARITY.md), so the tool
refuses any device but the CPU, and without --device cpu it exits 2.
Exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from percepnet_tpu_torch.enhance import enhance_spectra
from percepnet_tpu_torch.features.frontend import analyze_batch
from percepnet_tpu_torch.features.labels import make_labels
from percepnet_tpu_torch.io.flat_npz import params_from_flat
from percepnet_tpu_torch.ops.activations import sigmoid_approx, tansig_approx
from percepnet_tpu_torch.tools import device_or_exit

GOLD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens")
PCM_GATE, GR_GATE = 1e-4, 1e-5


@torch.no_grad()
def errors(gold_dir: str = GOLD) -> dict:
    """The three gates' measured errors on the goldens in gold_dir."""
    g = np.load(os.path.join(gold_dir, "featgen.npz"))
    nn = np.load(os.path.join(gold_dir, "nn.npz"))

    def analyze(x):
        return analyze_batch(torch.from_numpy(x.astype(np.float32))[None])[0]

    # oracle path, at featgen's raw int16 scale
    clean_out = analyze(g["clean16"])
    noisy_out = analyze(g["noisy16"])
    lab = make_labels({k: v[0] for k, v in clean_out.items()},
                      {k: v[0] for k, v in noisy_out.items()})
    pcm, _ = enhance_spectra(noisy_out, lab["g"][None], lab["r"][None])
    oracle = np.abs(pcm[0].numpy() - g["oracle_pcm"].astype(np.float32))
    out = {"oracle_pcm": float(oracle.max()) / 32768.0}

    # NN path, at percepNet_run's /32768 scale with its activations
    model = params_from_flat(nn)
    front = analyze(g["noisy16"].astype(np.float32) / 32768.0)
    gains, strengths, _ = model(front["features"], act_tanh=tansig_approx,
                                act_sigmoid=sigmoid_approx)
    out["gr"] = max(
        float(np.abs(gains[0].numpy() - nn["gr"][:, :34]).max()),
        float(np.abs(strengths[0].numpy() - nn["gr"][:, 34:]).max()))
    pcm, _ = enhance_spectra(front, gains, strengths)
    ours = pcm[0].numpy()[480:] * 32768.0      # the binary drops frame 0
    ref = nn["out_pcm"].astype(np.float32)
    out["nn_pcm"] = float(np.abs(ours[: len(ref)] - ref).max()) / 32768.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch.tools.check_parity",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu: the gates are defined on the host CPU")
    args = ap.parse_args(argv)
    dev = device_or_exit("check_parity", args.device)
    if dev.type != "cpu":
        print("check_parity: the strict gates are defined on the host "
              "CPU; pass --device cpu", file=sys.stderr)
        return 2

    err = errors()
    print(f"oracle PCM max normalized err: {err['oracle_pcm']:.3g}")
    print(f"g/r max err vs C inference: {err['gr']:.3g}")
    print(f"NN-enhanced PCM max normalized err: {err['nn_pcm']:.3g}")
    failed = [name for name, gate in (("oracle_pcm", PCM_GATE),
                                      ("gr", GR_GATE), ("nn_pcm", PCM_GATE))
              if not err[name] < gate]
    if failed:
        print(f"PARITY FAILED: {', '.join(failed)}")
        return 1
    print("PARITY OK: all paths < 1e-4 normalized PCM on host CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
