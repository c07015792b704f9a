"""Forward products rounded once from f64, for holding one device's f32
training gradient against another's.

From a random init on raw-scale records the input stack's gradient is
ill-conditioned in f32.  The record's pitch correlation (column 69, up
to ~1e9, which log1p leaves alone) drives fc and conv1 to ~1e7, so
nearly every conv2 pre-activation saturates tanh.  The few that do not
decide conv2's, conv1's and fc's gradients, and one of them can be the
difference of terms ~1e7 times its size: its f32 value, and so its
tanh', then depend on the order the GEMM sums in, and the gradient
entries it reaches move with it.  Any two f32 summation orders (the
CPU's and the card's, or either against the correctly rounded product)
give gradients some 1e-1 of a leaf's max apart there, while the f64
gradients of the two devices agree to 1e-7.

Under `ExactProducts` every f32 `torch.matmul` of the forward pass
returns the f64 product rounded once to f32, which is the same number on
every device; its gradient is still the plain f32 matmul's.  What is
left to differ between two devices is then each one's own elementwise
kernels and backward, which is what a device comparison should hold.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


class ExactProducts(TorchFunctionMode):
    """Within `with ExactProducts():`, each f32 torch.matmul's value is
    its f64 product rounded once; the backward is the f32 matmul's.
    Keep the backward inside the block: remat recomputes there."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.matmul and out.dtype == torch.float32:
            a, b = args
            with torch.no_grad():
                exact = torch.matmul(a.double(), b.double()).float()
            out = exact + (out - out.detach())
        return out
