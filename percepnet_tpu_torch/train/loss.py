"""PercepNet training loss (rnn_train.py:153-176, paper eq. 7): the port's
copy of percepnet_tpu/train/loss.py.

L = mean((g^γ - ĝ^γ)^2) + C4 * mean((g^γ - ĝ^γ)^4)
  + mean(((1-r)^γ - (1-r̂)^γ)^2),   γ = 0.5, C4 = 10.

The reference computes x^0.5 directly, whose gradient is infinite at 0
(its code says it "causes NaN, need fix", rnn_train.py:198).  `grad_eps`
is added inside the square root only (default 1e-10; 0.0 gives the
reference's values and its NaN behaviour).
"""

from __future__ import annotations

import torch

GAMMA = 0.5
C4 = 10.0


def percepnet_loss(outputs: torch.Tensor, targets: torch.Tensor,
                   grad_eps: float = 1e-10,
                   gain_mse_weight: float = 0.0) -> torch.Tensor:
    """outputs/targets: [..., 68] = concat(g[34], r[34]); a 0-d tensor.

    gain_mse_weight: optional extra linear-domain gain MSE term,
    `w * mean((g - ĝ)^2)`, which restores pressure at the high-gain end
    that the γ = 0.5 compression flattens.  0.0 is the reference's loss.
    """
    g_hat, r_hat = outputs[..., :34], outputs[..., 34:68]
    g, r = targets[..., :34], targets[..., 34:68]

    def pow_g(x):
        return torch.sqrt(x + grad_eps)

    dg = pow_g(g) - pow_g(g_hat)
    dr = pow_g(1.0 - r) - pow_g(1.0 - r_hat)
    loss = (torch.mean(dg * dg) + C4 * torch.mean(dg ** 4)
            + torch.mean(dr * dr))
    if gain_mse_weight:
        lin = g - g_hat
        loss = loss + gain_mse_weight * torch.mean(lin * lin)
    return loss
