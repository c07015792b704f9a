"""The comparison that decides `correct`: what the timed path produced
for the sampled streams or sessions, frame by frame, against the plain
reference's answer for the same inputs.

Numbers, each over every compared frame:
  period_mismatch_pct  share of frames whose pitch period differs;
  features_gap         the worst frame's |features - ref| / |ref| (L2
                       over the 70), among frames whose period agrees
                       (a period that differs changes the coherence
                       features by design);
  comb_gap             the same for the comb output's band energies ep;
  gr_gap               the largest |g - ref| or |r - ref|;
  pcm_gap              the worst frame's |pcm - ref| / |ref| (L2 over
                       its 480 samples; int16 values where the wire is
                       int16).
A frame's relative gap takes a floor beside its own norm in the
denominator, so that silence does not divide by zero: 1% of the
reference's median frame norm, and for PCM at least the norm of a frame
of one int16 step in every sample (an int16 wire cannot say less).
The numbers a cell is held to, and their limits, are in
benchmark/limits/<cell>.json.  A held number that the run could not
read (the loop did not capture the layer's output on every call) fails
`correct`, unless that file lists it under "not_captured".
"""

from __future__ import annotations

import json
import pathlib

import torch

FLOOR = 0.01
FRAME = 480


def _rel_gap(x: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
             least: float = 0.0) -> float:
    """The worst masked frame's L2 gap over its last axis, relative to
    the frame's norm plus a floor of max(least, 1% of the median)."""
    if not bool(mask.any()):
        return 0.0
    x, ref = x.to(torch.float64), ref.to(torch.float64)
    norm = torch.linalg.vector_norm(ref, dim=-1)
    floor = max(least, FLOOR * float(torch.median(norm[mask])))
    gap = torch.linalg.vector_norm(x - ref, dim=-1) / (norm + floor + 1e-30)
    return float(gap[mask].max())


def numbers(prog: dict, ref: dict, valid: torch.Tensor) -> dict:
    """prog, ref: period [N, T], features [N, T, 70], ep, g, r [N, T, 34],
    pcm [N, T, 480]; valid [N, T] marks the frames compared.  The
    intermediate keys are missing from prog where the loop did not
    capture them on every call: then only pcm_gap is read."""
    out = {"frames": int(valid.sum())}
    if "period" in prog:
        same = prog["period"].to(torch.int64) == ref["period"].to(
            torch.int64)
        out["period_mismatch_pct"] = 100.0 * float(
            (~same & valid).sum()) / max(1, out["frames"])
        agree = valid & same
        out["features_gap"] = _rel_gap(prog["features"], ref["features"],
                                       agree)
        out["comb_gap"] = _rel_gap(prog["ep"], ref["ep"], agree)
        gr = torch.maximum((prog["g"] - ref["g"]).abs().amax(-1),
                           (prog["r"] - ref["r"]).abs().amax(-1))
        out["gr_gap"] = float(gr[valid].max()) if bool(valid.any()) else 0.0
    step = 1.0 if ref["pcm"].dtype == torch.int16 else 1.0 / 32768.0
    out["pcm_gap"] = _rel_gap(prog["pcm"], ref["pcm"], valid,
                              step * FRAME ** 0.5)
    return out


def load_limits(root: pathlib.Path, cell: str) -> dict:
    """benchmark/limits/<cell>.json: {"limits": {number: limit},
    optionally "not_captured": [number, ...], and the readings the
    limits were set from}."""
    with open(root / "limits" / f"{cell}.json") as f:
        return json.load(f)


def verdict(nums: dict, spec: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limited number read
    and at or under its limit, and no failed answer.  A limited number
    that was not read is shown as null and fails, unless spec lists it
    under "not_captured"."""
    compared = {}
    ok = failed == 0
    excused = set(spec.get("not_captured", ()))
    for name, limit in spec["limits"].items():
        value = nums.get(name)
        compared[name] = {"value": value, "limit": limit}
        if value is None:
            ok = ok and name in excused
        else:
            ok = ok and value <= limit
    compared["failed"] = {"value": failed, "limit": 0}
    return ok, compared
