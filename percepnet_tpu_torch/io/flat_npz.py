"""Load the JAX package's flat `params/<layer>/<leaf>` weight arrays
(percepnet_tpu/io/flat_npz.py) into a PercepNet module, with numpy only.

Covers the checkpoints in artifacts/*.npz and the `params/*` keys of
tests/goldens/nn.npz; other keys in the mapping are ignored.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from percepnet_tpu_torch.models.percepnet import LAYERS, PercepNet


def params_from_flat(mapping) -> PercepNet:
    """A CPU PercepNet holding `mapping[f"params/{layer}/{leaf}"]` for
    every parameter; raises KeyError on a missing key and ValueError on a
    shape mismatch.  Move it with `.to(device)`."""
    model = PercepNet()
    with torch.no_grad():
        for layer, leaves in LAYERS.items():
            for leaf, shape in leaves.items():
                key = f"params/{layer}/{leaf}"
                arr = np.asarray(mapping[key], dtype=np.float32)
                if arr.shape != shape:
                    raise ValueError(f"{key}: shape {arr.shape}, expected "
                                     f"{shape}")
                getattr(model, layer)[leaf].copy_(torch.from_numpy(arr))
    return model


def load_params(path: str | os.PathLike) -> PercepNet:
    """params_from_flat of an .npz file."""
    with np.load(path) as data:
        return params_from_flat(data)
