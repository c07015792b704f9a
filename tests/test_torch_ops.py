"""The port's DSP ops and comb filter against the JAX package and the
reference goldens (tests/goldens/unit.npz).

Inputs are made with numpy from a seed and handed to both packages.  The
comb kernel itself runs only on a CUDA card (tests/test_torch_gpu.py);
here its plain version is held against the JAX gather formulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu import constants as JC
from percepnet_tpu.ops import activations as j_act
from percepnet_tpu.ops import bands as j_bands
from percepnet_tpu.ops import comb as j_comb
from percepnet_tpu.ops import dft as j_dft
from percepnet_tpu.ops import window as j_window
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import activations, bands, comb, dft, window
from percepnet_tpu_torch.ops.dispatch import resolve_device, resolve_impl

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    """max |a - b| over the reference's full scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", [
    "erb_band_borders", "band_energy_matrix", "band_interp_matrix",
    "half_vorbis_window", "full_window", "comb_hann_window",
    "tansig_table"])
def test_tables_equal_jax_package(name):
    np.testing.assert_array_equal(getattr(C, name)(), getattr(JC, name)())


def test_dft_tables_and_geometry_equal_jax_package():
    for mine, ref in zip(C.rdft_matrices() + C.irdft_matrices(),
                         JC.rdft_matrices() + JC.irdft_matrices()):
        assert mine.dtype == np.float32
        np.testing.assert_array_equal(mine, ref)
    for name in ("FRAME_SIZE", "WINDOW_SIZE", "FREQ_SIZE", "PITCH_BUF_SIZE",
                 "COMB_BUF_SIZE", "X_WINDOW_START", "NB_FEATURES",
                 "PITCH_T_NORM", "FEATURE_SCALE", "GRU_DIM", "RB_GRU_DIM"):
        assert getattr(C, name) == getattr(JC, name), name


def test_device_table_is_float32_and_rejects_float64():
    t = C.device_table(C.full_window, CPU)
    assert t.dtype == torch.float32 and t.shape == (C.WINDOW_SIZE,)
    assert C.device_table(C.full_window, CPU) is t      # built once

    def f64():
        return np.zeros(3)
    with pytest.raises(TypeError):
        C.device_table(f64, CPU)


def test_window_dft_bands_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, C.WINDOW_SIZE)).astype(np.float32)
    xw = window.apply_window(_t(x))
    np.testing.assert_array_equal(
        xw.numpy(), np.asarray(j_window.apply_window(jnp.asarray(x))))
    xr, xi = dft.forward_dft(xw)
    jr, ji = j_dft.forward_dft(jnp.asarray(xw.numpy()))
    assert _rel(xr, jr) < 1e-6 and _rel(xi, ji) < 1e-6
    assert _rel(dft.inverse_dft(xr, xi),
                j_dft.inverse_dft(jnp.asarray(xr.numpy()),
                                  jnp.asarray(xi.numpy()))) < 1e-6
    pr = _t(rng.standard_normal(xr.shape).astype(np.float32))
    pi = _t(rng.standard_normal(xr.shape).astype(np.float32))
    jargs = [jnp.asarray(v.numpy()) for v in (xr, xi, pr, pi)]
    assert _rel(bands.band_energy(xr, xi),
                j_bands.band_energy(*jargs[:2])) < 1e-6
    assert _rel(bands.band_corr(xr, xi, pr, pi),
                j_bands.band_corr(*jargs)) < 1e-6
    g = rng.random((2, 3, C.NB_BANDS)).astype(np.float32)
    assert _rel(bands.interp_band_gain(_t(g)),
                j_bands.interp_band_gain(jnp.asarray(g))) < 1e-6


def test_forward_dft_vs_kissfft(unit_goldens):
    x = unit_goldens["fft_in"]
    ref = unit_goldens["fft_out"].reshape(-1, 2)
    xr, xi = dft.forward_dft(_t(x)[None])
    np.testing.assert_allclose(xr[0].numpy(), ref[:, 0], atol=2e-7)
    np.testing.assert_allclose(xi[0].numpy(), ref[:, 1], atol=2e-7)
    back = dft.inverse_dft(xr, xi)
    np.testing.assert_allclose(back[0].numpy(), x, atol=1e-5)


def test_band_ops_vs_reference(unit_goldens):
    X = _t(unit_goldens["band_X"].reshape(-1, 2).T.copy())
    P = _t(unit_goldens["band_P"].reshape(-1, 2).T.copy())
    np.testing.assert_allclose(bands.band_energy(X[0], X[1]).numpy(),
                               unit_goldens["band_energy"], rtol=2e-6)
    np.testing.assert_allclose(
        bands.band_corr(X[0], X[1], P[0], P[1]).numpy(),
        unit_goldens["band_corr"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        bands.interp_band_gain(_t(unit_goldens["band_g_in"])).numpy(),
        unit_goldens["band_g_interp"], atol=1e-6)


def test_activations_match_jax_and_exact():
    x = np.linspace(-8, 8, 1001, dtype=np.float32)
    got = activations.tansig_approx(_t(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_act.tansig_approx(jnp.asarray(x))), atol=1e-7)
    np.testing.assert_allclose(got, np.tanh(x), atol=2e-6)
    s = activations.sigmoid_approx(_t(x)).numpy()
    np.testing.assert_allclose(
        s, np.asarray(j_act.sigmoid_approx(jnp.asarray(x))), atol=1e-7)


def test_dispatch_resolves_device_and_tier():
    assert resolve_device("cpu") == CPU
    assert resolve_impl(None, CPU) == "ref"
    assert resolve_impl("ref", CPU) == "ref"
    with pytest.raises(ValueError):
        resolve_impl("cuda", CPU)
    with pytest.raises(ValueError):
        resolve_impl("tpu", CPU)
    with pytest.raises(ValueError):
        resolve_device("meta")


def _comb_inputs(bsz, t, seed):
    rng = np.random.default_rng(seed)
    s_pad = rng.standard_normal(
        (bsz, t * C.FRAME_SIZE + 5280)).astype(np.float32)
    period = rng.integers(60, 770, (bsz, t)).astype(np.int32)
    return s_pad, period


@pytest.mark.parametrize("bsz,t", [(1, 1), (2, 1), (2, 7), (2, 40)])
def test_comb_ref_matches_jax_gather(bsz, t):
    s_pad, period = _comb_inputs(bsz, t, seed=t)
    ref = np.asarray(j_comb._comb_gather(jnp.asarray(s_pad),
                                         jnp.asarray(period), 2400))
    got = comb.comb_ref(_t(s_pad), _t(period), 2400)
    assert got.dtype == torch.float32 and got.shape == (bsz, t, 960)
    assert _rel(got, ref) <= 1e-6


def test_comb_dispatch_on_cpu_takes_plain_version():
    s_pad, period = _comb_inputs(2, 5, seed=3)
    before = comb.launches
    got = comb.comb_filter_windows_batch(_t(s_pad), _t(period), 2400)
    np.testing.assert_array_equal(
        got.numpy(), comb.comb_ref(_t(s_pad), _t(period), 2400).numpy())
    with pytest.raises(ValueError):
        comb.comb_filter_windows_batch(_t(s_pad), _t(period), 2400,
                                       impl="cuda")
    with pytest.raises(ValueError):
        comb.comb_cuda(_t(s_pad), _t(period), 2400)
    assert comb.launches == before


@pytest.mark.parametrize("bad", ["short", "rank", "float_period"])
def test_comb_rejects_bad_inputs(bad):
    s_pad, period = _comb_inputs(2, 4, seed=4)
    s, p = _t(s_pad), _t(period)
    if bad == "short":
        s = s[:, :3000]
    elif bad == "rank":
        p = p[0]
    else:
        p = p.float()
    with pytest.raises((ValueError, TypeError)):
        comb.comb_filter_windows_batch(s, p, 2400)
