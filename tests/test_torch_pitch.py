"""The port's pitch stack against the JAX package's 'cpu' tier and the
reference goldens (tests/goldens/unit.npz): periods exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.ops import pitch as j_pitch
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import pitch

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _voiced(bsz, n, seed):
    """Harmonic 'speech' with a gliding pitch plus noise, [bsz, n]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / C.SAMPLE_RATE
    out = np.empty((bsz, n), np.float32)
    for b in range(bsz):
        f0 = rng.uniform(90, 250) * (1 + 0.3 * np.sin(2 * np.pi * 0.7 * t))
        ph = 2 * np.pi * np.cumsum(f0) / C.SAMPLE_RATE
        s = sum(np.sin(k * ph) / k for k in range(1, 6))
        out[b] = 0.1 * s + 0.02 * rng.standard_normal(n)
    return out


@pytest.mark.parametrize("n", [864, 387, 100, 17, 16, 5])
def test_prefix_sum_is_bitwise_jax_cumsum(n):
    y = (np.random.default_rng(n).standard_normal((3, n)) ** 2).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(y))
    np.testing.assert_array_equal(pitch._prefix_sum(_t(y)).numpy(), ref)


def test_levinson_vs_reference(unit_goldens):
    ac = unit_goldens["lpc_ac"].astype(np.float32)
    ac2 = ac.copy()
    ac2[0] *= 1.0001
    for i in range(1, 5):
        ac2[i] -= ac2[i] * (0.008 * i) ** 2
    got = pitch._levinson4(_t(ac2)[None])[0].numpy()
    np.testing.assert_allclose(got, unit_goldens["lpc_coef"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(j_pitch._levinson4(jnp.asarray(ac2)[None]))[0],
        rtol=1e-6, atol=1e-7)


def test_pitch_downsample_vs_reference(unit_goldens):
    bufs = unit_goldens["pitch_buf"].reshape(3, C.PITCH_BUF_SIZE)
    ref = unit_goldens["pitch_ds"].reshape(3, C.PITCH_BUF_SIZE // 2)
    got = pitch.pitch_downsample(_t(bufs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-4)


def test_pitch_stack_vs_reference(unit_goldens):
    """Discrete period decisions of the reference, exactly."""
    bufs = _t(unit_goldens["pitch_buf"].reshape(3, C.PITCH_BUF_SIZE))
    ds = pitch.pitch_downsample(bufs)
    t0, corr = pitch.pitch_search(ds, pitch.full_xcorr(ds))
    np.testing.assert_array_equal(t0.numpy(),
                                  unit_goldens["pitch_index_search"])
    np.testing.assert_allclose(corr.numpy(), unit_goldens["pitch_corr"],
                               rtol=1e-4)
    track = pitch.pitch_track_ds(ds[None], torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1))
    np.testing.assert_array_equal(track["period"][0].numpy(),
                                  unit_goldens["pitch_index_final"])
    np.testing.assert_allclose(track["gain"][0].numpy(),
                               unit_goldens["pitch_gain"], rtol=1e-3,
                               atol=1e-4)


@pytest.fixture(scope="module")
def stream():
    bsz, t = 2, 24
    s_pad = np.concatenate(
        [np.zeros((bsz, 5280), np.float32), _voiced(bsz, t * 480, seed=5)],
        axis=1)
    return s_pad, t


def test_downsample_frames_from_stream_is_bitwise_jax(stream):
    """Decimation and whitening add in the JAX package's order on the CPU,
    so the whitened frames agree bit for bit."""
    s_pad, t = stream
    got = pitch.downsample_frames_from_stream(_t(s_pad), t, 1632)
    ref = j_pitch.downsample_frames_from_stream(jnp.asarray(s_pad), t, 1632)
    assert got.shape == (2, t, 864)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [864, 861, 480, 100, 34, 7])
def test_tree_sum_is_bitwise_jax_sum(n):
    y = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(y))
    np.testing.assert_array_equal(pitch._tree_sum(_t(y)).numpy(), ref)


def test_pitch_track_matches_jax(stream):
    """Same whitened frames into both trackers: periods exact, gains and
    correlations to f32 rounding."""
    s_pad, t = stream
    ds = np.asarray(j_pitch.downsample_frames_from_stream(
        jnp.asarray(s_pad), t, 1632))
    p0 = np.array([0, 300], np.int32)
    g0 = np.array([0.0, 0.5], np.float32)
    ref = jax.vmap(lambda d, p, g: j_pitch.pitch_track_ds(d, p, g,
                                                          impl="cpu"))(
        jnp.asarray(ds), jnp.asarray(p0), jnp.asarray(g0))
    got = pitch.pitch_track_ds(_t(ds), _t(p0), _t(g0))
    assert got["period"].dtype == torch.int32
    np.testing.assert_array_equal(got["period"].numpy(),
                                  np.asarray(ref["period"]))
    np.testing.assert_array_equal(got["final_period"].numpy(),
                                  np.asarray(ref["final_period"]))
    assert _rel(got["gain"], ref["gain"]) < 1e-5
    assert _rel(got["corr"], ref["corr"]) < 1e-5
    # the test signal is voiced: the tracker must find periods, not zeros
    assert (got["period"].numpy() >= C.PITCH_MIN_PERIOD).all()


def test_pitch_track_carry_chunked_equals_oneshot(stream):
    s_pad, t = stream
    ds = pitch.downsample_frames_from_stream(_t(s_pad), t, 1632)
    zeros_p, zeros_g = torch.zeros(2, dtype=torch.int32), torch.zeros(2)
    full = pitch.pitch_track_ds(ds, zeros_p, zeros_g)
    a = pitch.pitch_track_ds(ds[:, :10], zeros_p, zeros_g)
    b = pitch.pitch_track_ds(ds[:, 10:], a["final_period"], a["final_gain"])
    np.testing.assert_array_equal(
        torch.cat([a["period"], b["period"]], 1).numpy(),
        full["period"].numpy())
