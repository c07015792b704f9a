"""The port's objective evaluation (cli.evaluate, utils.pesq,
utils.filterbanks, utils.metrics.snr_db) against the JAX package's on the
same seeded numpy inputs, on the CPU.  Tolerance: 1e-6 (both are numpy
and scipy on the host, so they agree to the last bit in practice)."""

import json

import numpy as np
import pytest

from percepnet_tpu.cli.evaluate import evaluate_pair as j_evaluate_pair
from percepnet_tpu.io.pcm import write_pcm16
from percepnet_tpu.utils import filterbanks as j_filterbanks
from percepnet_tpu.utils import metrics as j_metrics
from percepnet_tpu.utils.pesq import pesq_like as j_pesq_like
from percepnet_tpu_torch import __main__ as dispatcher
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.cli.evaluate import evaluate_pair
from percepnet_tpu_torch.utils import filterbanks, metrics
from percepnet_tpu_torch.utils.pesq import pesq_like

TOL = 1e-6


def _speech(seed, seconds=2.0):
    """A broadband harmonic stack with a wobbling pitch (covers the STOI
    third-octave bands)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 48000)) / 48000
    phase = np.cumsum(180 + 40 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t)
                      ) / 48000
    return 0.05 * sum(np.sin(2 * np.pi * h * phase) / np.sqrt(h)
                      for h in range(1, 30))


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """clean, noisy and a lagging enhanced-like file (delayed by the
    enhancer's FRAME_LOOKAHEAD frames, tests/test_cli.py's case)."""
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(13)
    clean = _speech(1)
    noisy = clean + 0.02 * rng.normal(size=clean.size)
    lag = C.FRAME_LOOKAHEAD * C.FRAME_SIZE
    lagging = np.concatenate([np.zeros(lag), clean])[: clean.size]
    lagging = lagging + 1e-4 * rng.normal(size=clean.size)
    paths = {}
    for name, x in (("clean", clean), ("noisy", noisy),
                    ("lagging", lagging)):
        paths[name] = str(d / f"{name}.pcm")
        write_pcm16(paths[name], x, scale=32768.0)
    return paths


@pytest.mark.parametrize("other,align", [("noisy", False), ("noisy", True),
                                         ("lagging", True),
                                         ("clean", False)])
def test_evaluate_pair_matches_jax(pair_files, other, align):
    ours = evaluate_pair(pair_files["clean"], pair_files[other], align=align)
    theirs = j_evaluate_pair(pair_files["clean"], pair_files[other],
                             align=align)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= TOL, (k, ours[k], theirs[k])
    if other == "lagging":
        # the alignment drops the lag from the ENHANCED side
        assert ours["si_sdr_db"] > 30 and ours["stoi"] > 0.99


def test_pesq_like_and_snr_match_jax():
    rng = np.random.default_rng(2)
    clean = _speech(2, 1.5)
    for noise in (0.003, 0.03):
        deg = clean + noise * rng.normal(size=clean.size)
        assert abs(pesq_like(clean, deg) - j_pesq_like(clean, deg)) <= TOL
        assert abs(metrics.snr_db(clean, deg)
                   - j_metrics.snr_db(clean, deg)) <= TOL


@pytest.mark.parametrize("fn", ["erb_cosine_filters", "linear_filters"])
def test_filterbanks_match_jax(fn):
    for kw in ({}, {"nfft": 512, "sample_rate": 16000, "n_bands": 20,
                    "high_hz": 7000.0}):
        ours = getattr(filterbanks, fn)(**kw)
        theirs = getattr(j_filterbanks, fn)(**kw)
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, atol=TOL)
    np.testing.assert_allclose(filterbanks.erb_space(50.0, 8000.0, 10),
                               j_filterbanks.erb_space(50.0, 8000.0, 10),
                               atol=TOL)


def test_evaluate_cli_json(pair_files, tmp_path, capsys):
    """--pairs-file --json prints every pair and the mean of each
    metric."""
    pf = tmp_path / "pairs.txt"
    pf.write_text(f"{pair_files['clean']} {pair_files['noisy']}\n\n"
                  f"{pair_files['clean']} {pair_files['lagging']}\n")
    dispatcher.main(["evaluate", "--pairs-file", str(pf), "--json",
                     "--device", "cpu"])
    res = json.loads(capsys.readouterr().out)
    assert len(res["pairs"]) == 2
    for k in ("stoi", "si_sdr_db", "snr_db", "pesq_like_uncal"):
        assert res["mean"][k] == pytest.approx(
            np.mean([p[k] for p in res["pairs"]]), abs=1e-4)
