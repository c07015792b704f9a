"""Parse and emit the reference's generated C weight source
(`nnet_data.cpp`), on numpy: the port's counterpart of
percepnet_tpu/io/nnet_data.py, whose text it reproduces byte for byte.

  * `model_from_nnet_data_cpp` imports a generated file into a PercepNet,
    inverting dump_percepnet.py's conversions: dense weights stored
    [in, out]; GRU gates regrouped (z, r, n) -> (r, z, n) and the biases
    stored interleaved as [ih; hh] = 6N; conv weights [k, in, out].
  * `emit_nnet_data_cpp` writes a PercepNet in that format, for the
    reference's C runtime.

Plain `.cpp` only, as in the JAX package.
"""

from __future__ import annotations

import re

import numpy as np

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.io.flat_npz import params_from_flat, params_to_flat
from percepnet_tpu_torch.models.percepnet import PercepNet

# the C runtime's gate blocks are (z, r, n), the model's (r, z, n); the
# swap is its own inverse
_GATE_SWAP = [1, 0, 2]

_ARRAY = re.compile(r"static const float (\w+)\[\d+\] = \{(.*?)\};", re.S)


def _parse_arrays(text: str) -> dict[str, np.ndarray]:
    """Every `static const float name[n] = {...};` as f32.  Each literal
    is read as a double first, then cast, as the JAX package's parser
    reads it, so both give the same f32 values."""
    out = {}
    for m in _ARRAY.finditer(text):
        body = m.group(2).replace("f", "")
        out[m.group(1)] = np.array(
            [v for v in body.split(",") if v.strip()],
            np.float64).astype(np.float32)
    return out


def _regroup_gates(mat: np.ndarray, n: int) -> np.ndarray:
    """Swap the first two of the three [., n] gate blocks on the last
    axis."""
    blocks = [mat[..., i * n : (i + 1) * n] for i in range(3)]
    return np.concatenate([blocks[i] for i in _GATE_SWAP], axis=-1)


def model_from_nnet_data_cpp(path: str) -> PercepNet:
    """A CPU PercepNet from a generated nnet_data.cpp."""
    with open(path) as f:
        arrs = _parse_arrays(f.read())
    d, g, rb = C.CONV_DIM, C.GRU_DIM, C.RB_GRU_DIM
    flat = {}

    def lin(name, n_in, n_out):
        flat[f"params/{name}/w"] = arrs[f"{name}_weights"].reshape(n_in,
                                                                   n_out)
        flat[f"params/{name}/b"] = arrs[f"{name}_bias"]

    def conv(name, k, n_in, n_out):
        flat[f"params/{name}/w"] = arrs[f"{name}_weights"].reshape(
            k, n_in, n_out)
        flat[f"params/{name}/b"] = arrs[f"{name}_bias"]

    def gru(name, n_in, n):
        flat[f"params/{name}/wi"] = _regroup_gates(
            arrs[f"{name}_weights"].reshape(n_in, 3 * n), n)
        flat[f"params/{name}/wh"] = _regroup_gates(
            arrs[f"{name}_recurrent_weights"].reshape(n, 3 * n), n)
        bias = arrs[f"{name}_bias"].reshape(2, 3, n)[:, _GATE_SWAP, :]
        flat[f"params/{name}/bi"] = bias[0].reshape(-1)
        flat[f"params/{name}/bh"] = bias[1].reshape(-1)

    lin("fc", C.INPUT_DIM, C.FC_DIM)
    conv("conv1", C.CONV1_KERNEL, C.FC_DIM, d)
    conv("conv2", C.CONV2_KERNEL, d, d)
    for name in ("gru1", "gru2", "gru3", "gru_gb"):
        gru(name, d if name == "gru1" else g, g)
    gru("gru_rb", 2 * g, rb)
    lin("fc_gb", 5 * d, C.NB_BANDS)
    lin("fc_rb", rb, C.NB_BANDS)
    return params_from_flat(flat)


def _fmt_array(name: str, vals: np.ndarray) -> str:
    """A C array of the values' shortest double reprs, 8 per line (the
    JAX package's _fmt_array, percepnet_tpu/io/nnet_data.py:77)."""
    flat = np.asarray(vals, np.float32).reshape(-1).astype(
        np.float64).tolist()
    body = ",\n   ".join(
        ", ".join(map(repr, flat[i : i + 8]))
        for i in range(0, len(flat), 8))
    return f"static const float {name}[{len(flat)}] = {{\n   {body}\n}};\n\n"


def emit_nnet_data_cpp(model: PercepNet, path: str) -> None:
    """Write the model as a reference-compatible src/nnet_data.cpp."""
    p = params_to_flat(model)
    # the JAX package's header, so that both packages write one text
    out = ["/* Generated by percepnet_tpu.io.nnet_data */\n\n",
           '#include "nnet.h"\n#include "nnet_data.h"\n\n']

    def dense(name, act):
        w, b = p[f"params/{name}/w"], p[f"params/{name}/b"]
        n_in, n_out = w.shape
        out.append(_fmt_array(f"{name}_weights", w))
        out.append(_fmt_array(f"{name}_bias", b))
        out.append(f"const DenseLayer {name} = {{\n   {name}_bias,\n"
                   f"   {name}_weights,\n   {n_in}, {n_out}, "
                   f"ACTIVATION_{act}\n}};\n\n")

    def conv(name, act):
        w, b = p[f"params/{name}/w"], p[f"params/{name}/b"]
        k, n_in, n_out = w.shape
        out.append(_fmt_array(f"{name}_weights", w))
        out.append(_fmt_array(f"{name}_bias", b))
        out.append(f"const Conv1DLayer {name} = {{\n   {name}_bias,\n"
                   f"   {name}_weights,\n   {n_in}, {k}, {n_out}, "
                   f"ACTIVATION_{act}\n}};\n\n")

    def gru(name):
        wi = p[f"params/{name}/wi"]
        n_in, n3 = wi.shape
        n = n3 // 3
        bias = np.stack([p[f"params/{name}/bi"].reshape(3, n)[_GATE_SWAP],
                         p[f"params/{name}/bh"].reshape(3, n)[_GATE_SWAP]])
        out.append(_fmt_array(f"{name}_weights", _regroup_gates(wi, n)))
        out.append(_fmt_array(f"{name}_recurrent_weights",
                              _regroup_gates(p[f"params/{name}/wh"], n)))
        out.append(_fmt_array(f"{name}_bias", bias))
        out.append(f"const GRULayer {name} = {{\n   {name}_bias,\n"
                   f"   {name}_weights,\n   {name}_recurrent_weights,\n"
                   f"   {n_in}, {n}, ACTIVATION_TANH, 1\n}};\n\n")

    dense("fc", "RELU")
    conv("conv1", "RELU")
    conv("conv2", "TANH")
    for name in ("gru1", "gru2", "gru3", "gru_gb", "gru_rb"):
        gru(name)
    dense("fc_gb", "SIGMOID")
    dense("fc_rb", "SIGMOID")

    names = ["fc", "conv1", "conv2", "gru1", "gru2", "gru3",
             "gru_gb", "gru_rb", "fc_gb", "fc_rb"]
    out.append("extern const RNNModel percepnet_model_orig = {\n")
    out.extend(f"    &{n},\n" for n in names)
    out.append("};\n")
    with open(path, "w") as f:
        f.write("".join(out))
