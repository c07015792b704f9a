"""Import rnn_train.py PercepNet state_dicts (the reference's PyTorch
training checkpoints) into the port's PercepNet.

Layout mapping (rnn_train.py -> PercepNet, whose weights are [in, out] as
in the JAX package, percepnet_tpu/io/torch_import.py:7-16):
  Linear.weight [out, in]        -> w [in, out]     (transpose)
  Conv1d.weight [out, in, k]     -> w [k, in, out]  (permute 2, 1, 0); tap
                                    k=0 is the oldest frame under the
                                    reference's causal pad + trim
  GRU.weight_ih_l0 [3N, in]      -> wi [in, 3N]     (transpose; gate order
                                    r, z, n kept)
  GRU.bias_ih_l0 / bias_hh_l0    -> bi / bh
"""

from __future__ import annotations

import numpy as np

from percepnet_tpu_torch.io.flat_npz import params_from_flat
from percepnet_tpu_torch.models.percepnet import LAYERS, PercepNet


def _leaves(sd, layer: str) -> dict[str, np.ndarray]:
    if layer.startswith("gru"):
        return {"wi": sd[f"{layer}.weight_ih_l0"].T,
                "wh": sd[f"{layer}.weight_hh_l0"].T,
                "bi": sd[f"{layer}.bias_ih_l0"],
                "bh": sd[f"{layer}.bias_hh_l0"]}
    w = sd[f"{layer}.0.weight"]
    return {"w": w.transpose(2, 1, 0) if layer.startswith("conv") else w.T,
            "b": sd[f"{layer}.0.bias"]}


def model_from_state_dict(sd) -> PercepNet:
    """A CPU PercepNet from an rnn_train.py state_dict (tensors or
    ndarrays); raises KeyError on a missing entry and ValueError on a
    shape mismatch."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
              else np.asarray(v)) for k, v in sd.items()}
    return params_from_flat({f"params/{layer}/{leaf}": arr
                             for layer in LAYERS
                             for leaf, arr in _leaves(sd, layer).items()})
