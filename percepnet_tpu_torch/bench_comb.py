"""Check and time the comb kernels on the card: v1 (csrc/comb.cu) and the
row-layout v2 (csrc/comb_rows.cu), each with an f32 and a bf16 store.

The counterpart of the JAX package's tools/bench_comb.py, and the path
that reaches v2, which the pipeline never dispatches.  At each shape the
main path gives the kernel (64 x 1, a serving tick; 16 x 200, a batch
call; 64 x 100; 512 x 200, whose 600 MB overflow the 50 MB L2, so that
its byte bound at the device-memory rate is a floor), every variant is
held against the plain version (ops.comb.comb_ref) bit for bit, on a
4-row slice of a shape over 64 rows, the bf16 store of each variant
against its own f32 store rounded to bf16, and v2's f32 store against
v1's; then each variant and the plain version are timed at the full
shape with CUDA events, beside the byte bound and the share of it the
kernel reaches.

    python -m percepnet_tpu_torch.bench_comb [--batch B --frames T]

Prints one JSON line of checks and times per shape, and exits non-zero if
a check fails.  Needs a CUDA card.
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
SHAPES = ((64, 1), (16, 200), (64, 100), (512, 200))
CHECK_ROWS = 4                   # rows checked of a shape over 64 rows
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


def edge_inputs(batch: int = 64, frames: int = 101, seed: int = 1,
                device: str | torch.device = "cuda"):
    """make_inputs with edge periods (max_p = max_period(...), 800 here):
    row 0's first tile of 8 holds max_p, max_p + 1 (a NaN frame), 60, 769
    and -1; row 1's ragged last tile (101 = 12*8 + 5) holds max_p and two
    max_p + 1; row 2 is all 60; row 3's frames 8..15 are all out of range
    (a tile with nothing to stage)."""
    s_pad, period = make_inputs(batch, frames, seed, device)
    mp = comb.max_period(frames, s_pad.shape[1], X_OFFSET)
    p = period.cpu()
    p[0, :8] = torch.tensor([mp, mp + 1, 60, 769, mp, -1, 60, mp])
    p[1, -5:] = torch.tensor([mp, mp + 1, 60, mp, mp + 1])
    p[2] = 60
    p[3, 8:16] = mp + 1
    return s_pad, p.to(period.device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    view = torch.int32 if x.dtype == torch.float32 else torch.int16
    return x.contiguous().view(view)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, any NaN matching any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def check(s_pad: torch.Tensor, period: torch.Tensor,
          grids=(None,)) -> dict:
    """Each variant and store against the plain version, launched in each
    of `grids` (None: the wrapper's own tiles); returns, per
    `<variant>_<store>`, the max abs error over finite values and whether
    every launch is bit-exact (NaN frames where the plain version has
    them), and the two store probes."""
    ref = {tag: comb.comb_ref(s_pad, period, X_OFFSET, dt)
           for tag, dt in STORES.items()}
    layouts = {"v1": ("windows", C.WINDOW_SIZE),
               "v2": ("rows", comb.ROW_LEN)}
    out, res = {}, {}
    for name in VARIANTS:
        layout, width = layouts[name]
        for tag, dt in STORES.items():
            err, exact = 0.0, True
            for grid in grids:
                got = comb._launch(layout, width, s_pad, period, X_OFFSET,
                                   dt, grid)[..., :C.WINDOW_SIZE]
                out.setdefault((name, tag), got)
                diff = (got.float() - ref[tag].float()).abs()
                diff = diff[torch.isfinite(diff)]
                err = max(err, diff.max().item() if diff.numel() else 0.0)
                exact = exact and same_bits(got, ref[tag])
            res[f"{name}_{tag}"] = {"max_abs_err": err, "bit_exact": exact}
        res[f"{name}_bf16_is_rn_f32"] = same_bits(
            out[name, "bf16"], out[name, "f32"].to(torch.bfloat16))
    res["v2_f32_is_v1_f32"] = same_bits(out["v2", "f32"], out["v1", "f32"])
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
    the bound and each variant's share of it; keys `<variant>_<store>`,
    `plain_<store>`, `bound_<store>` and `share_<variant>_<store>`."""
    bsz, t = period.shape
    res = {}
    for tag, dt in STORES.items():
        res[f"bound_{tag}"], res["bound_by"] = bound(bsz, t, s_pad.shape[1],
                                                     dt)
        for name, fn in VARIANTS.items():
            ms = res[f"{name}_{tag}"] = time_ms(
                lambda: fn(s_pad, period, X_OFFSET, dt), runs=runs)
            res[f"share_{name}_{tag}"] = res[f"bound_{tag}"] / ms
        res[f"plain_{tag}"] = time_ms(
            lambda: comb.comb_ref(s_pad, period, X_OFFSET, dt), runs=runs)
    return res


def check_slice(s_pad: torch.Tensor, period: torch.Tensor):
    """The rows check() holds against the plain version: all of them, or
    the first CHECK_ROWS of a shape over 64 rows (the plain version's
    gathers are large at 512 x 200)."""
    if period.shape[0] <= 64:
        return s_pad, period
    return (s_pad[:CHECK_ROWS].contiguous(),
            period[:CHECK_ROWS].contiguous())


def run_shape(batch: int, frames: int, runs: int = 25) -> dict:
    """Check (in the wrapper's tiles for the checked rows and for the
    whole shape) and time one shape."""
    s_pad, period = make_inputs(batch, frames)
    grid = comb.tile_grid(batch, frames)
    return {"batch": batch, "frames": frames, "grid": list(grid),
            "checks": check(*check_slice(s_pad, period), grids=(None, grid)),
            "ms": time_variants(s_pad, period, runs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, help="one shape instead of the "
                    "four of the main path (with --frames)")
    ap.add_argument("--frames", type=int)
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args(argv)
    if (args.batch is None) != (args.frames is None):
        ap.error("--batch and --frames go together")
    if not torch.cuda.is_available():
        print("bench_comb: no CUDA device is available", file=sys.stderr)
        return 2
    shapes = SHAPES if args.batch is None else ((args.batch, args.frames),)
    ok = True
    for batch, frames in shapes:
        row = run_shape(batch, frames, args.runs)
        row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        ok = ok and all_exact(row["checks"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
