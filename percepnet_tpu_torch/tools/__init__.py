"""The port's measurement and quality tools, the counterparts of the JAX
package's tools/ (which import percepnet_tpu, so none of them runs where
the card is).  Each is `python -m percepnet_tpu_torch.tools.<name>` with
a `main(argv=None)`, and runs on the card unless given --device cpu:

  profile_pipeline  per-stage wall and device time, launches, busy share
  flop_bound        per-stage FLOPs, bytes and bound at the H100's peaks
  quality_gate      STOI / SI-SDR of f32 and bf16 enhancement on a holdout
  scaling_bench     weak scaling of the data-parallel training step
  check_parity      the strict gates against the C binary's goldens (CPU)
  check_all         parity + quality as one exit code
"""

from __future__ import annotations

import sys

import torch

from percepnet_tpu_torch.ops.dispatch import resolve_device


def device_or_exit(tool: str, device: str | None) -> torch.device:
    """The tool's device: the card unless --device cpu.  Without a card
    (and without --device cpu) the tool exits with code 2 and a message;
    it never runs on the host unasked."""
    try:
        return resolve_device(device)
    except RuntimeError:
        print(f"{tool}: no CUDA card is available; pass --device cpu to "
              f"run on the host", file=sys.stderr)
        raise SystemExit(2) from None
