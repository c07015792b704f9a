"""Ground-truth label generation (the reference `train()` math), on
tensors: the port's counterpart of percepnet_tpu/features/labels.py.

Reproduces denoise.cpp:549-589 and the record layout of
denoise.cpp:761-773: 138 float32 per frame = [Ey_lookahead(34),
Ephaty(34), T(1), pitch_corr(1), g(34), r(34)].

  * g is an energy ratio Ex/Ey, not an amplitude ratio (denoise.cpp:573).
  * Eyp correlates the NOISY spectrum with the CLEAN stream's comb
    spectrum (denoise.cpp:736), normalized by sqrt(.001 + Ey*Ep_clean).
  * The reference builds with TEST=1 (denoise.cpp:45-47), so
    post_filtering changes g in place on the oracle path before the record
    is written (denoise.cpp:743 vs :772): the dumped targets are
    post-filtered gains.  `make_records(apply_postfilter=True)` reproduces
    that; False gives the gains before it.

Every function takes single-utterance [T, ...] or batched [B, T, ...]
analysis dicts (features.frontend.analyze_utterance / analyze_batch).
"""

from __future__ import annotations

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import bands
from percepnet_tpu_torch.ops.postfilter import post_filter


def estimate_phat_corr(eyp: torch.Tensor) -> torch.Tensor:
    """Ephatp = Eyp / sqrt((1-pna)*Eyp^2 + pna)  (denoise.cpp:549-553)."""
    pna = C.power_noise_attenuation()
    return eyp / torch.sqrt((1.0 - pna) * eyp * eyp + pna)


def filter_strength_calc(exp: torch.Tensor, eyp: torch.Tensor,
                         ephatp: torch.Tensor) -> torch.Tensor:
    """Quadratic solve for the pitch-filter strength r
    (denoise.cpp:555-569)."""
    a = torch.clamp(ephatp * ephatp - exp * exp, min=0.0)
    b = ephatp * eyp * (1.0 - exp * exp)
    c = torch.clamp(exp * exp - eyp * eyp, min=0.0)
    alpha = (torch.sqrt(b * b + a * c) - b) / (a + 1e-8)
    return alpha / (1.0 + alpha)


def calc_ideal_gain(ex: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
    """g = clip(Ex / (1e-4 + Ey), 0, 1)  (denoise.cpp:571-577)."""
    return torch.clamp(ex / (1e-4 + ey), 0.0, 1.0)


def adjust_gain_strength(ephatp: torch.Tensor, exp: torch.Tensor,
                         g: torch.Tensor, r: torch.Tensor):
    """Attenuate g and force r = 0.99 where the coherence cannot be
    restored (denoise.cpp:579-589)."""
    cond = ephatp < exp
    g_att = torch.sqrt((1.0 + C.N0 - exp * exp)
                       / (1.0 + C.N0 - ephatp * ephatp))
    g = torch.where(cond, g * g_att, g)
    r = torch.where(cond, torch.full_like(r, 0.99), r)
    return g, r


def make_labels(clean_out: dict, noisy_out: dict, *,
                apply_postfilter: bool = True) -> dict:
    """Per-frame training targets (g, r) from both streams' analyses.

    Args:
      clean_out, noisy_out: analyses of the clean and noisy signals at raw
        int16 amplitude (NORM_RATIO=1).
    Returns:
      dict(g, r, eyp, ephatp), each [..., T, 34].
    """
    ex, ey = clean_out["ex"], noisy_out["ex"]
    g = calc_ideal_gain(ex, ey)

    # Eyp: noisy spectrum vs CLEAN comb spectrum (denoise.cpp:736-737)
    eyp = bands.band_corr(noisy_out["xr"], noisy_out["xi"],
                          clean_out["pr"], clean_out["pi"])
    eyp = torch.clamp(eyp / torch.sqrt(1e-3 + ey * clean_out["ep"]),
                      0.0, 1.0)

    ephatp = estimate_phat_corr(noisy_out["exp"])
    r = filter_strength_calc(clean_out["exp"], noisy_out["exp"], ephatp)
    g, r = adjust_gain_strength(ephatp, clean_out["exp"], g, r)
    if apply_postfilter:
        g = post_filter(g, ey)
    return dict(g=g, r=r, eyp=eyp, ephatp=ephatp)


def make_records(clean_out: dict, noisy_out: dict, *,
                 apply_postfilter: bool = True) -> torch.Tensor:
    """[..., T, 138] f32 training records in the reference layout
    (denoise.cpp:761-773)."""
    labels = make_labels(clean_out, noisy_out,
                         apply_postfilter=apply_postfilter)
    t = noisy_out["period"].to(torch.float32) / C.PITCH_T_NORM
    return torch.cat([
        noisy_out["ey_look"],
        noisy_out["exp"],
        t[..., None],
        noisy_out["corr"][..., None],
        labels["g"],
        labels["r"],
    ], dim=-1)
