"""The port's analysis front-end against JAX analyze_batch(impl='cpu').

Bounds: pitch periods and silence flags exact; spectra, band energies,
pitch gains and correlations within 1e-5 of each array's full scale.
The band coherence `exp` (and its x30 feature columns) is a ratio of band
energies: in near-silent bands both energies are at the DFT's rounding
level, so the two DFT products' different summation orders show there
amplified.  It is held to 1e-4 absolute on its [0, 1] scale, the repo's
cross-implementation coherence bound (tests/test_featgen_parity.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.features import frontend as j_frontend
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.features import frontend

torch.set_num_threads(2)

B, T = 2, 40


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(7)
    n = np.arange(T * C.FRAME_SIZE) / C.SAMPLE_RATE
    f0 = np.array([[150.0], [210.0]]) * (1 + 0.2 * np.sin(2 * np.pi * n))
    ph = 2 * np.pi * np.cumsum(f0, axis=-1) / C.SAMPLE_RATE
    voiced = sum(np.sin(k * ph) / k for k in range(1, 5))
    return (0.1 * voiced + 0.02 * rng.standard_normal((B, n.size))).astype(
        np.float32)


@pytest.fixture(scope="module")
def both(signal):
    ref, ref_state = j_frontend.analyze_batch(jnp.asarray(signal), impl="cpu")
    out, state = frontend.analyze_batch(torch.from_numpy(signal))
    return ({k: np.asarray(v) for k, v in ref.items()}, ref_state,
            {k: v.numpy() for k, v in out.items()}, state)


def test_frontend_output_shapes(both):
    _, _, out, state = both
    assert out["features"].shape == (B, T, C.NB_FEATURES)
    assert out["xr"].shape == (B, T, C.FREQ_SIZE)
    assert out["period"].dtype == np.int32
    assert state.tail.shape == (B, frontend.PAD)
    assert all(np.isfinite(v).all() for v in out.values()
               if v.dtype.kind == "f")


def test_frontend_discrete_outputs_exact(both):
    ref, ref_state, out, state = both
    np.testing.assert_array_equal(out["period"], ref["period"])
    np.testing.assert_array_equal(out["silence"], ref["silence"])
    np.testing.assert_array_equal(state.period.numpy(),
                                  np.asarray(ref_state.period))
    np.testing.assert_array_equal(
        np.round(out["features"][..., 68] * C.PITCH_T_NORM),
        np.round(ref["features"][..., 68] * C.PITCH_T_NORM))


@pytest.mark.parametrize("key", ["xr", "xi", "pr", "pi", "ex", "ep",
                                 "ey_look", "gain", "corr"])
def test_frontend_continuous_outputs_match_jax(both, key):
    ref, _, out, _ = both
    assert _rel(out[key], ref[key]) <= 1e-5, key


def test_frontend_features_match_jax(both):
    ref, ref_state, out, state = both
    f, r = out["features"], ref["features"]
    assert _rel(f[..., :34], r[..., :34]) <= 1e-5          # lookahead energy
    assert _rel(f[..., 69], r[..., 69]) <= 1e-5            # pitch corr
    assert np.abs(out["exp"] - ref["exp"]).max() <= 1e-4   # coherence
    assert np.abs(f[..., 34:68] - r[..., 34:68]).max() <= 1e-4 * \
        C.FEATURE_SCALE
    np.testing.assert_array_equal(state.tail.numpy(),
                                  np.asarray(ref_state.tail))
    assert _rel(state.gain.numpy(), np.asarray(ref_state.gain)) <= 1e-5


def test_frontend_chunked_with_state_equals_oneshot(signal, both):
    _, _, out, state = both
    st, parts = None, []
    for i in range(4):
        chunk = signal[:, i * 10 * C.FRAME_SIZE:(i + 1) * 10 * C.FRAME_SIZE]
        o, st = frontend.analyze_batch(torch.from_numpy(chunk), st)
        parts.append(o)
    got = {k: torch.cat([p[k] for p in parts], 1).numpy() for k in out}
    np.testing.assert_array_equal(got["period"], out["period"])
    np.testing.assert_array_equal(st.period.numpy(), state.period.numpy())
    for key in ("xr", "ex", "ey_look", "gain", "corr"):
        assert _rel(got[key], out[key]) <= 1e-5, key
    assert np.abs(got["features"] - out["features"]).max() <= \
        1e-4 * C.FEATURE_SCALE


def test_frontend_rejects_partial_frames():
    with pytest.raises(ValueError):
        frontend.analyze_batch(torch.zeros(1, C.FRAME_SIZE + 7))
