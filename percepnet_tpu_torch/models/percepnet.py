"""The PercepNet gain/strength network as an nn.Module.

Architecture (mirrors rnn_train.py:105-145 / rnn.cpp:42-81):
  fc:      Linear(70 -> 128)  + ReLU
  conv1:   causal Conv1d(128 -> 512, k=5) + ReLU
  conv2:   causal Conv1d(512 -> 512, k=3) + Tanh
  gru1..3: GRU(512 -> 512)
  gru_gb:  GRU(512 -> 512)            (input: gru3 output)
  gru_rb:  GRU(1024 -> 128)           (input: [gru3, conv2] concat)
  fc_gb:   Linear(2560 -> 34) + Sigmoid  on [conv2, gru1..3, gru_gb]
  fc_rb:   Linear(128 -> 34)  + Sigmoid  on gru_rb
  ~7.96 M parameters, f32.  The bf16 serving tier (compute_dtype) runs
  them, the features and the recurrence in bf16.

Parameters keep the JAX package's names and layouts ([in, out] weights,
GRU gates in PyTorch's r, z, n order), so `io.flat_npz.params_from_flat`
loads its checkpoints without reordering and each product is `x @ w + b`
as there.  The five GRUs run in one explicit loop over time, for the
exact and the compat (C tansig table) activations alike: the compat
tables cannot go through nn.GRU, and one loop keeps one arithmetic.  The
input projections that do not depend on recurrent state (gru1's, and the
conv half of gru_rb's) are hoisted out of the loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from percepnet_tpu_torch import constants as C

# (layer, {leaf: shape}) in the JAX package's PercepNetParams order
_D, _G, _RB = C.CONV_DIM, C.GRU_DIM, C.RB_GRU_DIM


def _dense(n_in, n_out):
    return {"w": (n_in, n_out), "b": (n_out,)}


def _conv(n_in, n_out, k):
    return {"w": (k, n_in, n_out), "b": (n_out,)}


def _gru(n_in, n_hidden):
    return {"wi": (n_in, 3 * n_hidden), "wh": (n_hidden, 3 * n_hidden),
            "bi": (3 * n_hidden,), "bh": (3 * n_hidden,)}


LAYERS: dict[str, dict[str, tuple[int, ...]]] = {
    "fc": _dense(C.INPUT_DIM, C.FC_DIM),
    "conv1": _conv(C.FC_DIM, _D, C.CONV1_KERNEL),
    "conv2": _conv(_D, _D, C.CONV2_KERNEL),
    "gru1": _gru(_D, _G),
    "gru2": _gru(_G, _G),
    "gru3": _gru(_G, _G),
    "gru_gb": _gru(_G, _G),
    "gru_rb": _gru(2 * _G, _RB),
    "fc_gb": _dense(5 * _D, C.NB_BANDS),
    "fc_rb": _dense(_RB, C.NB_BANDS),
}


def weight_count() -> int:
    """Entries of LAYERS' weights (biases left out): the multiply-adds of
    one stream's frame through the forward pass, since each weight
    multiplies once per frame."""
    return sum(math.prod(shape) for leaves in LAYERS.values()
               for leaf, shape in leaves.items() if leaf.startswith("w"))


def _fan_in(layer: str, shape: tuple[int, ...]) -> int:
    """PyTorch-default init bound 1/sqrt(fan): GRUs use the hidden size,
    convs in*k, dense layers their input width."""
    if layer.startswith("gru"):
        return shape[-1] // 3
    if layer.startswith("conv"):
        return LAYERS[layer]["w"][0] * LAYERS[layer]["w"][1]
    return LAYERS[layer]["w"][0]


class ModelState(NamedTuple):
    """Streaming state: conv tap memories + 5 GRU hidden states
    (RNNState, nnet_data.h:28-38)."""
    conv1_mem: torch.Tensor   # [B, 4, 128]
    conv2_mem: torch.Tensor   # [B, 2, 512]
    h1: torch.Tensor          # [B, 512]
    h2: torch.Tensor
    h3: torch.Tensor
    h_gb: torch.Tensor        # [B, 512]
    h_rb: torch.Tensor        # [B, 128]


def init_model_state(batch: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> ModelState:
    """Zero state; dtype is the forward pass's compute_dtype (f32 default)."""
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return ModelState(
        conv1_mem=z(batch, C.CONV1_KERNEL - 1, C.FC_DIM),
        conv2_mem=z(batch, C.CONV2_KERNEL - 1, C.CONV_DIM),
        h1=z(batch, _G), h2=z(batch, _G), h3=z(batch, _G),
        h_gb=z(batch, _G), h_rb=z(batch, _RB))


def compress_features(features: torch.Tensor) -> torch.Tensor:
    """log1p-compress the 68 energy/coherence feature dims (T and corr
    stay raw).  Models trained with log1p_features (the round-5
    checkpoint) must be served with it."""
    return torch.cat([torch.log1p(features[..., :68]), features[..., 68:]],
                     dim=-1)


def _causal_conv(p, x, mem, act):
    """Causal 1-D conv as K shifted matmuls: tap k=0 is the oldest frame,
    the streaming state layout of nnet.cpp:182-200.
    x [B, T, in], mem [B, K-1, in] -> (out [B, T, out], new_mem)."""
    k = p["w"].shape[0]
    xp = torch.cat([mem, x], dim=1)
    t = x.shape[1]
    out = p["b"]
    for i in range(k):
        out = out + torch.matmul(xp[:, i : i + t], p["w"][i])
    return act(out), xp[:, t:].contiguous()


def _project(p, x):
    return torch.matmul(x, p["wi"]) + p["bi"]


def _gru_cell(p, h, x_proj, sigmoid, tanh):
    """One GRU step given x_proj = x@wi + bi.  PyTorch semantics
    (reset-after, gates r, z, n), identical to compute_gru with
    reset_after=1 (nnet.cpp:120-180):
      r = sig(xr + hr); z = sig(xz + hz); n = tanh(xn + r*hn)
      h' = (1-z)*n + z*h
    """
    gh = torch.matmul(h, p["wh"]) + p["bh"]
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = sigmoid(xr + hr)
    z = sigmoid(xz + hz)
    cand = tanh(xn + r * hn)
    return (1.0 - z) * cand + z * h


class PercepNet(nn.Module):
    """PercepNet with PyTorch-default uniform initialization drawn from
    `generator` (a fresh generator seeded with 0 when None).  Load trained
    weights with io.flat_npz.params_from_flat."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer, leaves in LAYERS.items():
            params = nn.ParameterDict()
            for leaf, shape in leaves.items():
                bound = 1.0 / math.sqrt(_fan_in(layer, shape))
                data = torch.rand(shape, generator=generator) * (2 * bound) \
                    - bound
                params[leaf] = nn.Parameter(data)
            setattr(self, layer, params)

    def forward(self, features: torch.Tensor, state: ModelState | None = None,
                *, act_tanh: Callable = torch.tanh,
                act_sigmoid: Callable = torch.sigmoid,
                log1p_features: bool = False,
                compute_dtype: torch.dtype | None = None,
                remat: bool = False):
        """Whole-sequence forward pass.

        Args:
          features: [B, T, 70] f32 model input (already x30-scaled).
          state: streaming ModelState (None = zeros), in compute_dtype.
          act_tanh, act_sigmoid: exact (default) or the C tables
            (ops.activations.tansig_approx / sigmoid_approx).
          log1p_features: apply compress_features at the model input (in
            f32, before any cast).
          compute_dtype: the serving dtype (torch.bfloat16): parameters,
            features and the recurrence run in it; both heads' sigmoids
            take their logits in f32.  Parameters are cast per call
            unless the module already holds that dtype (the server keeps
            a bf16 copy).  None: f32.
          remat: rematerialize each frame's five-GRU step in backward
            (torch.utils.checkpoint, the counterpart of JAX's
            jax.checkpoint on the scan step): only the carried hidden
            states are kept per frame, and backward recomputes the gates.
            Training only; inference leaves it off.
        Returns:
          (g [B, T, 34] f32, r [B, T, 34] f32, new_state)
        """
        dtype = compute_dtype or torch.float32
        b, t, _ = features.shape
        if log1p_features:
            features = compress_features(features)
        if state is None:
            state = init_model_state(b, features.device, dtype)
        elif state.h1.dtype != dtype:
            raise ValueError(f"state is {state.h1.dtype}, the pass runs in "
                             f"{dtype}: init_model_state(..., dtype) must "
                             f"match compute_dtype")
        features = features.to(dtype)
        p = {layer: {leaf: v.to(dtype) for leaf, v in
                     getattr(self, layer).items()} for layer in LAYERS}

        x = torch.relu(torch.matmul(features, p["fc"]["w"]) + p["fc"]["b"])
        c1, c1_mem = _causal_conv(p["conv1"], x, state.conv1_mem, torch.relu)
        conv_out, c2_mem = _causal_conv(p["conv2"], c1, state.conv2_mem,
                                        act_tanh)

        # state-independent input projections, hoisted out of the loop
        pre1 = _project(p["gru1"], conv_out)                     # [B,T,1536]
        wi_rb = p["gru_rb"]["wi"]
        pre_rb_conv = torch.matmul(conv_out, wi_rb[_G:]) + p["gru_rb"]["bi"]

        def step(h1, h2, h3, hgb, hrb, p1, prbc):
            h1 = _gru_cell(p["gru1"], h1, p1, act_sigmoid, act_tanh)
            h2 = _gru_cell(p["gru2"], h2, _project(p["gru2"], h1),
                           act_sigmoid, act_tanh)
            h3 = _gru_cell(p["gru3"], h3, _project(p["gru3"], h2),
                           act_sigmoid, act_tanh)
            hgb = _gru_cell(p["gru_gb"], hgb, _project(p["gru_gb"], h3),
                            act_sigmoid, act_tanh)
            prb = prbc + torch.matmul(h3, wi_rb[:_G])
            hrb = _gru_cell(p["gru_rb"], hrb, prb, act_sigmoid, act_tanh)
            return h1, h2, h3, hgb, hrb

        hs = (state.h1, state.h2, state.h3, state.h_gb, state.h_rb)
        seqs = ([], [], [], [], [])
        for i in range(t):
            if remat:
                hs = checkpoint(step, *hs, pre1[:, i], pre_rb_conv[:, i],
                                use_reentrant=False,
                                preserve_rng_state=False)   # no dropout
            else:
                hs = step(*hs, pre1[:, i], pre_rb_conv[:, i])
            for seq, h in zip(seqs, hs):
                seq.append(h)
        h1, h2, h3, hgb, hrb = hs
        h1s, h2s, h3s, hgbs, hrbs = (torch.stack(s, dim=1) for s in seqs)

        w_gb = p["fc_gb"]["w"]
        gb_logits = (torch.matmul(conv_out, w_gb[:_D])
                     + torch.matmul(h1s, w_gb[_D : 2 * _D])
                     + torch.matmul(h2s, w_gb[2 * _D : 3 * _D])
                     + torch.matmul(h3s, w_gb[3 * _D : 4 * _D])
                     + torch.matmul(hgbs, w_gb[4 * _D :])
                     + p["fc_gb"]["b"])
        rb_logits = torch.matmul(hrbs, p["fc_rb"]["w"]) + p["fc_rb"]["b"]
        gains = act_sigmoid(gb_logits.to(torch.float32))
        strengths = act_sigmoid(rb_logits.to(torch.float32))
        new_state = ModelState(c1_mem, c2_mem, h1, h2, h3, hgb, hrb)
        return gains, strengths, new_state


def forward_stream(model: PercepNet, features: torch.Tensor,
                   state: ModelState, **kw):
    """Single-frame streaming step: features [B, 70] -> (g [B, 34],
    r [B, 34], state).  kw as PercepNet.forward."""
    g, r, st = model(features[:, None], state, **kw)
    return g[:, 0], r[:, 0], st


def param_count(model: PercepNet) -> int:
    """Entries of every parameter, biases included (the JAX package's
    param_count; weight_count() leaves the biases out)."""
    return sum(p.numel() for p in model.parameters())
