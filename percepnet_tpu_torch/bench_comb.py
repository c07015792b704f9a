"""Check and time the comb kernels on the card: v1 (csrc/comb.cu) and the
row-layout v2 (csrc/comb_rows.cu), each with an f32 and a bf16 store.

The counterpart of the JAX package's tools/bench_comb.py, and the path
that reaches v2, which the pipeline never dispatches.  Every variant is
held against the plain version (ops.comb.comb_ref) bit for bit on a
slice of the batch, the bf16 store of each variant against its own f32
store rounded to bf16, and v2's f32 store against v1's; then each variant
and the plain version are timed at the full shape with CUDA events.

    python -m percepnet_tpu_torch.bench_comb [--batch 512] [--frames 200]

Prints one JSON line of checks and one of times, and exits non-zero if a
check fails.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import comb
from percepnet_tpu_torch.utils.profiling import bound_ms, time_ms

X_OFFSET = 2400
VARIANTS = {"v1": comb.comb_cuda, "v2": comb.comb_cuda_rows}
STORES = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_inputs(batch: int, frames: int, seed: int = 0,
                device: str | torch.device = "cuda"):
    """s_pad [batch, frames*480 + 5280] (5280 leading zeros, then noise
    at 0.05) and period int32 [batch, frames] in 60..769, from a seed."""
    rng = np.random.default_rng(seed)
    s_pad = np.zeros((batch, frames * C.FRAME_SIZE + 5280), np.float32)
    s_pad[:, 5280:] = 0.05 * rng.standard_normal(
        (batch, frames * C.FRAME_SIZE))
    period = rng.integers(C.PITCH_MIN_PERIOD, 770, (batch, frames))
    return (torch.from_numpy(s_pad).to(device),
            torch.from_numpy(period.astype(np.int32)).to(device))


def _bits(x: torch.Tensor) -> torch.Tensor:
    view = torch.int32 if x.dtype == torch.float32 else torch.int16
    return x.contiguous().view(view)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def check(s_pad: torch.Tensor, period: torch.Tensor) -> dict:
    """Each variant and store against the plain version; returns, per
    `<variant>_<store>`, its max abs error and whether it is bit-exact,
    and the two store probes."""
    ref = {tag: comb.comb_ref(s_pad, period, X_OFFSET, dt)
           for tag, dt in STORES.items()}
    out, res = {}, {}
    for name, fn in VARIANTS.items():
        for tag, dt in STORES.items():
            got = out[name, tag] = fn(s_pad, period, X_OFFSET, dt)
            res[f"{name}_{tag}"] = {
                "max_abs_err": (got.float() - ref[tag].float()).abs().max()
                .item(),
                "bit_exact": _same_bits(got, ref[tag])}
        res[f"{name}_bf16_is_rn_f32"] = _same_bits(
            out[name, "bf16"], out[name, "f32"].to(torch.bfloat16))
    res["v2_f32_is_v1_f32"] = _same_bits(out["v2", "f32"], out["v1", "f32"])
    return res


def all_exact(res: dict) -> bool:
    return all(v["bit_exact"] if isinstance(v, dict) else v
               for v in res.values())


def bound(batch: int, frames: int, n_pad: int,
          store: torch.dtype) -> tuple[float, str]:
    """Least time for the comb function at this shape: s_pad, period and
    the two tables read once and [B, T, 960] written once in the store
    type, or 15 flops per output at the f32 peak."""
    out_bytes = torch.finfo(store).bits // 8
    n_bytes = 4 * (batch * n_pad + batch * frames + C.WINDOW_SIZE + 7) \
        + out_bytes * batch * frames * C.WINDOW_SIZE
    return bound_ms(n_bytes, 15 * batch * frames * C.WINDOW_SIZE)


def time_variants(s_pad: torch.Tensor, period: torch.Tensor,
                  runs: int = 25) -> dict:
    """Device ms of each variant and of the plain version per store, with
    the bound; keys `<variant>_<store>` and `plain_<store>`."""
    bsz, t = period.shape
    res = {}
    for tag, dt in STORES.items():
        for name, fn in VARIANTS.items():
            res[f"{name}_{tag}"] = time_ms(
                lambda: fn(s_pad, period, X_OFFSET, dt), runs=runs)
        res[f"plain_{tag}"] = time_ms(
            lambda: comb.comb_ref(s_pad, period, X_OFFSET, dt), runs=runs)
        res[f"bound_{tag}"], res["bound_by"] = bound(bsz, t, s_pad.shape[1],
                                                     dt)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_comb: no CUDA device is available", file=sys.stderr)
        return 2
    s_pad, period = make_inputs(args.batch, args.frames)
    # the plain version's gathers are large at full shape: check 4 rows
    checks = check(s_pad[:4].contiguous(), period[:4].contiguous())
    print(json.dumps({"checks": checks}), flush=True)
    times = time_variants(s_pad, period, args.runs)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch": args.batch, "frames": args.frames,
                      "ms": times}), flush=True)
    return 0 if all_exact(checks) else 1


if __name__ == "__main__":
    sys.exit(main())
