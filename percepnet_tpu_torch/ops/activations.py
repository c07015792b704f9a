"""Bit-compat variants of the reference's table-based activations
(vec.h:33-75), for holding the port against models run by the C binary.

The default model path uses exact torch.tanh / torch.sigmoid.
"""

from __future__ import annotations

import torch

from percepnet_tpu_torch import constants as C


def tansig_approx(x: torch.Tensor) -> torch.Tensor:
    """Table-based tanh matching vec.h:53-70 (tansig_approx).

    i = clip(floor(.5 + 25|x|), 0, 200); dx = |x| - .04i; y = T[i];
    y += dx*(1-y^2)*(1 - y*dx); the result takes x's sign.
    """
    table = C.device_table(C.tansig_table, x.device)
    sign = torch.sign(x)
    ax = torch.abs(x)
    i = torch.clamp(torch.floor(0.5 + 25.0 * ax), 0, 200).to(torch.int64)
    dx = ax - 0.04 * i.to(torch.float32)
    y = table[i]
    dy = 1.0 - y * y
    y = y + dx * dy * (1.0 - y * dx)
    return sign * y


def sigmoid_approx(x: torch.Tensor) -> torch.Tensor:
    """Matches vec.h:72-75: .5 + .5*tansig_approx(.5x)."""
    return 0.5 + 0.5 * tansig_approx(0.5 * x)
