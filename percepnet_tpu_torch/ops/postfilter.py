"""TeaPoly envelope post-filter (post_filtering, denoise.cpp:216-250)."""

from __future__ import annotations

import math

import torch

from percepnet_tpu_torch import constants as C


def post_filter(g: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
    """Warp per-band gains and apply global energy compensation.

    g_w = g * sin(pi/2 * g);  E_div = sum(g*Ey) / (sum(g_w*Ey) + 1e-6);
    G = sqrt((1+beta) E_div / (1 + beta E_div^2));  returns G * g_w.

    The reference runs it only on the oracle/TEST path (denoise.cpp:743),
    so its dumped training targets are post-filtered gains; the label
    generator (features.labels) reproduces that.

    Args:
      g:  [..., NB_BANDS] gains.
      ey: [..., NB_BANDS] noisy band energies.
    """
    beta = C.ENVELOPE_POSTFILTERING_BETA
    g_w = g * torch.sin((math.pi / 2.0) * g)
    e0 = torch.sum(g * ey, dim=-1, keepdim=True)
    e1 = torch.sum(g_w * ey, dim=-1, keepdim=True)
    e_div = e0 / (e1 + 1e-6)
    big_g = torch.sqrt(((1 + beta) * e_div) / (1 + beta * e_div * e_div))
    return big_g * g_w
