"""The port's thin entry points and re-exports against the JAX package's,
on the CPU, with the same inputs on both sides.

Bounds:
  - pitch_track: periods exact; corr rtol 1e-4, gain rtol 1e-3 / atol
    1e-4 (tests/test_torch_pitch.py's bounds against the goldens);
  - forward_stream: g/r within 1e-5 of JAX's forward_stream at every
    frame (tests/test_torch_model.py's bound), and of the port's own
    whole-sequence forward;
  - param_count: equal;
  - comb_filter_windows: max error <= 1e-6 of the output's scale
    (tests/test_torch_ops.py's bound for the comb).
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import percepnet_tpu
import percepnet_tpu_torch
from percepnet_tpu.io.flat_npz import params_from_flat as j_params_from_flat
from percepnet_tpu.io.flat_npz import params_to_flat as j_params_to_flat
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.ops import comb as j_comb
from percepnet_tpu.ops import pitch as j_pitch
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import models, ops
from percepnet_tpu_torch.io.flat_npz import params_from_flat
from percepnet_tpu_torch.models.percepnet import LAYERS, weight_count

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "artifacts", "exp_log1p_30000_params.npz")
CPU = torch.device("cpu")
# JAX names the port spells otherwise: the nn.Module holds the params and
# draws the init, and the whole-sequence forward is its method
RENAMED = {"PercepNetParams": "PercepNet", "init_params": "PercepNet",
           "forward": "PercepNet.forward"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _voiced_buffers(t, seed):
    """[t, 1728] pitch buffers at hop 480 over a gliding harmonic signal
    with noise."""
    rng = np.random.default_rng(seed)
    n = (t - 1) * C.FRAME_SIZE + C.PITCH_BUF_SIZE
    time = np.arange(n) / C.SAMPLE_RATE
    f0 = 140.0 * (1 + 0.3 * np.sin(2 * np.pi * 0.7 * time))
    ph = 2 * np.pi * np.cumsum(f0) / C.SAMPLE_RATE
    x = 0.1 * sum(np.sin(k * ph) / k for k in range(1, 6)) \
        + 0.02 * rng.standard_normal(n)
    idx = np.arange(t)[:, None] * C.FRAME_SIZE + np.arange(C.PITCH_BUF_SIZE)
    return x.astype(np.float32)[idx]


@pytest.mark.parametrize("case", ["goldens", "goldens_carry", "voiced"])
def test_pitch_track_matches_jax(unit_goldens, case):
    if case == "voiced":
        bufs, carry = _voiced_buffers(16, seed=7), (None, None)
    else:
        bufs = unit_goldens["pitch_buf"].reshape(3, C.PITCH_BUF_SIZE)
        carry = (None, None) if case == "goldens" else (150, 0.6)
    want = j_pitch.pitch_track(jnp.asarray(bufs), *carry)
    got = ops.pitch_track(_t(bufs), *carry)
    assert got["period"].dtype == torch.int32
    assert got["period"].shape == (len(bufs),)
    np.testing.assert_array_equal(got["period"].numpy(),
                                  np.asarray(want["period"]))
    np.testing.assert_allclose(got["corr"].numpy(), np.asarray(want["corr"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(want["gain"]),
                               rtol=1e-3, atol=1e-4)
    assert int(got["final_period"]) == int(want["final_period"])
    np.testing.assert_allclose(float(got["final_gain"]),
                               float(want["final_gain"]), rtol=1e-3,
                               atol=1e-4)
    if case == "goldens":
        np.testing.assert_array_equal(got["period"].numpy(),
                                      unit_goldens["pitch_index_final"])


@pytest.fixture(scope="module")
def weights():
    """The round-5 checkpoint on both sides."""
    with np.load(CHECKPOINT) as data:
        flat = dict(data)
    jp = j_params_from_flat(j_model.init_params(jax.random.PRNGKey(0)), flat)
    return jp, params_from_flat(flat)


def _features(bsz, t, seed):
    rng = np.random.default_rng(seed)
    f = rng.random((bsz, t, C.NB_FEATURES)).astype(np.float32)
    f[..., :68] *= 300.0
    f[..., 68] = rng.integers(60, 769, (bsz, t)) / C.PITCH_T_NORM
    return f


def test_forward_stream_matches_jax_and_whole_sequence(weights):
    jp, model = weights
    feats = _features(2, 6, seed=4)
    jst = j_model.init_model_state(2)
    st = models.init_model_state(2, CPU)
    with torch.no_grad():
        g_all, r_all, _ = model(_t(feats), log1p_features=True)
        for i in range(feats.shape[1]):
            jg, jr, jst = j_model.forward_stream(
                jp, jnp.asarray(feats[:, i]), jst, log1p_features=True)
            g, r, st = models.forward_stream(model, _t(feats[:, i]), st,
                                             log1p_features=True)
            assert g.shape == r.shape == (2, C.NB_BANDS)
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
            np.testing.assert_allclose(g.numpy(), g_all[:, i].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(r.numpy(), r_all[:, i].numpy(),
                                       atol=1e-5)
    np.testing.assert_allclose(st.h_rb.numpy(), np.asarray(jst.h_rb),
                               atol=1e-5)


def test_param_count_matches_jax():
    """Weights drawn by JAX's init_params, carried across as flat arrays."""
    jp = j_model.init_params(jax.random.PRNGKey(3))
    model = params_from_flat(j_params_to_flat(jp))
    n_bias = sum(int(np.prod(shape)) for leaves in LAYERS.values()
                 for leaf, shape in leaves.items() if leaf.startswith("b"))
    assert models.param_count(model) == j_model.param_count(jp) == 7_962_564
    assert models.param_count(model) == weight_count() + n_bias


@pytest.mark.parametrize("t", [1, 9])
def test_comb_filter_windows_matches_jax(t):
    rng = np.random.default_rng(t)
    s_pad = rng.standard_normal(t * C.FRAME_SIZE + 5280).astype(np.float32)
    period = rng.integers(60, 770, t).astype(np.int32)
    want = np.asarray(j_comb.comb_filter_windows(
        jnp.asarray(s_pad), t, 2400, jnp.asarray(period)))
    got = ops.comb_filter_windows(_t(s_pad), t, 2400, _t(period))
    assert got.shape == (t, C.WINDOW_SIZE) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


def _jax_exports(rel_path):
    """The names a JAX package __init__ imports."""
    tree = ast.parse(open(os.path.join(ROOT, rel_path)).read())
    return sorted(a.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("jax_init,port", [
    ("percepnet_tpu/ops/__init__.py", ops),
    ("percepnet_tpu/models/__init__.py", models)])
def test_every_jax_reexport_has_its_counterpart(jax_init, port):
    names = _jax_exports(jax_init)
    assert len(names) >= 6
    for name in names:
        target = RENAMED.get(name, name)
        obj = port
        for part in target.split("."):
            obj = getattr(obj, part, None)
        assert callable(obj), f"{port.__name__} lacks {name} ({target})"


def test_top_level_reexports_are_lazy():
    """`import percepnet_tpu_torch` imports no pipeline until a pipeline
    name is read; the TF32 switches are set at import."""
    code = (
        "import sys, torch, percepnet_tpu_torch as P\n"
        "assert 'percepnet_tpu_torch.pipeline' not in sys.modules\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "f = P.enhance_chunk\n"
        "assert 'percepnet_tpu_torch.pipeline' in sys.modules\n"
        "print(f.__module__, P.constants.FRAME_SIZE)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["percepnet_tpu_torch.pipeline", "480"]
    names = set(percepnet_tpu._PIPELINE_EXPORTS) | {"constants"}
    assert len(names) == 5 and names <= set(dir(percepnet_tpu))
    assert names <= set(dir(percepnet_tpu_torch))
    for name in names - {"constants"}:
        assert getattr(percepnet_tpu_torch, name) is getattr(
            percepnet_tpu_torch.pipeline, name)
    with pytest.raises(AttributeError):
        percepnet_tpu_torch.no_such_name
