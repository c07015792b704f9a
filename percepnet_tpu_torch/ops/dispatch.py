"""Device and implementation-tier resolution, threaded explicitly.

Two tiers compute the same functions:

  ref   plain PyTorch on any device — the reduction orders of the JAX
        package's 'cpu' tier, which the strict parity goldens were
        validated against.  Used for tensors on the CPU.
  cuda  the hand-written CUDA kernels (ops.comb).  Used for tensors on
        the card.

The tier follows the device of the data: a CUDA tensor always takes the
`cuda` tier, a CPU tensor the `ref` tier.  An explicit `impl` that
disagrees with the device raises; nothing falls back silently.  Entry
points resolve the device once (`resolve_device`) and pass the tier down
(pipeline.enhance_chunk(impl=...) -> features.frontend.analyze_batch ->
ops).
"""

from __future__ import annotations

import torch

VALID_IMPLS = ("ref", "cuda")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for the CPU.  Raises when a card is asked for (or defaulted to)
    and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host")
    return dev


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """The tier for data on `device`: 'cuda' on the card, 'ref' on the CPU.

    impl=None picks it from the device; an explicit value must agree."""
    expected = "cuda" if device.type == "cuda" else "ref"
    if impl is None:
        return expected
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS} or None, "
                         f"got {impl!r}")
    if impl != expected:
        raise ValueError(
            f"impl={impl!r} cannot run on a {device.type} tensor "
            f"(tier {expected!r})")
    return impl
