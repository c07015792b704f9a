"""Weights as flat `params/<layer>/<leaf>` arrays in an .npz, with numpy
only: the JAX package's weight-exchange format (percepnet_tpu/io/
flat_npz.py, train/checkpoint.py), so files written by either package
load in the other.

`load_params` reads a params-only file (artifacts/*.npz, the `params/*`
keys of tests/goldens/nn.npz) and the `params/*` subtree of a full
TrainState checkpoint (the one with `step`) alike, without rebuilding
the optimizer state; other keys are ignored.
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


def params_to_flat(model: PercepNet) -> dict[str, np.ndarray]:
    """The model's parameters as f32 `params/<layer>/<leaf>` arrays, in
    the JAX package's PercepNetParams order."""
    return {f"params/{layer}/{leaf}":
            getattr(model, layer)[leaf].detach().to(
                device="cpu", dtype=torch.float32).numpy()
            for layer, leaves in LAYERS.items() for leaf in leaves}


def load_params(path: str | os.PathLike) -> PercepNet:
    """params_from_flat of an .npz file: params-only or a TrainState
    checkpoint."""
    with np.load(path) as data:
        return params_from_flat(data)


def save_params_npz(path: str | os.PathLike, model: PercepNet) -> None:
    """Params-only export (the deployment artifact), with the keys the JAX
    package's train.checkpoint.save_params_npz writes."""
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    np.savez(path, **params_to_flat(model))
