"""The port's enhance_chunk end to end: against the JAX pipeline, against
the C binary's output on tests/goldens/nn.npz, and as a streaming
function (chunked == one-shot, lookahead delay, flush), on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu import pipeline as j_pipeline
from percepnet_tpu.io.flat_npz import params_from_flat as j_params_from_flat
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import enhance, pipeline
from percepnet_tpu_torch.features import frontend
from percepnet_tpu_torch.io.flat_npz import load_params, params_from_flat
from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.ops import activations
from percepnet_tpu_torch.serve import StreamingServer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(__file__))
CHECKPOINT = os.path.join(ROOT, "artifacts", "exp_log1p_30000_params.npz")
NN_GOLDEN = os.path.join(ROOT, "tests", "goldens", "nn.npz")
CPU = "cpu"


def _noisy(bsz, n_frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * C.FRAME_SIZE) / C.SAMPLE_RATE
    tone = 0.1 * np.sin(2 * np.pi * rng.uniform(120, 300, (bsz, 1)) * t)
    return (tone + 0.05 * rng.standard_normal(tone.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    return PercepNet(torch.Generator().manual_seed(0))


def test_enhance_chunk_matches_jax_pipeline():
    """Round-5 checkpoint, log1p features: PCM within 1e-4 (normalized),
    g/r within 1e-5."""
    with np.load(CHECKPOINT) as data:
        flat = dict(data)
    sig = _noisy(2, 30, seed=1)
    jp = j_params_from_flat(j_model.init_params(jax.random.PRNGKey(0)), flat)
    j_pcm, _, (j_g, j_r) = j_pipeline.enhance_chunk(
        jp, jnp.asarray(sig), j_pipeline.init_pipeline_state(2),
        return_gr=True, impl="cpu", log1p_features=True)
    pcm, state, (g, r) = pipeline.enhance_chunk(
        params_from_flat(flat), sig, pipeline.init_pipeline_state(
            2, device=CPU), return_gr=True, device=CPU, log1p_features=True)
    assert pcm.shape == sig.shape and pcm.dtype == torch.float32
    assert np.abs(pcm.numpy() - np.asarray(j_pcm)).max() <= 1e-4
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(j_r), atol=1e-5)
    assert state.synthesis_mem.shape == (2, C.FRAME_SIZE)


@pytest.fixture(scope="module")
def nn_run(featgen_goldens):
    """The C binary's weights (nnet_data export) with compat activations
    over the golden 200-frame clip."""
    m = load_params(NN_GOLDEN)
    noisy = torch.from_numpy(
        featgen_goldens["noisy16"].astype(np.float32) / 32768.0)[None]
    with torch.no_grad():
        front, _ = frontend.analyze_batch(noisy)
        g, r, _ = m(front["features"], act_tanh=activations.tansig_approx,
                    act_sigmoid=activations.sigmoid_approx)
        pcm, _ = enhance.enhance_spectra(front, g, r)
    with np.load(NN_GOLDEN) as data:
        golden = {"gr": data["gr"], "out_pcm": data["out_pcm"]}
    return golden, g[0].numpy(), r[0].numpy(), pcm[0].numpy()


def test_gains_strengths_match_c(nn_run):
    golden, g, r, _ = nn_run
    np.testing.assert_allclose(g, golden["gr"][:, :34], atol=1e-5)
    np.testing.assert_allclose(r, golden["gr"][:, 34:], atol=1e-5)


def test_enhanced_pcm_matches_c(nn_run):
    golden, _, _, pcm = nn_run
    ref = golden["out_pcm"].astype(np.float32)
    # the reference drops its first output frame (main.cpp:37)
    ours = pcm[C.FRAME_SIZE : C.FRAME_SIZE + len(ref)] * 32768.0
    err = np.abs(ours - ref) / 32768.0
    assert err.max() < 1e-4, f"max normalized PCM err {err.max():.3g}"


def test_streaming_equals_oneshot(model):
    sig = _noisy(1, 20, seed=2)
    full, _ = pipeline.enhance_chunk(
        model, sig, pipeline.init_pipeline_state(1, device=CPU), device=CPU)
    state = pipeline.init_pipeline_state(1, device=CPU)
    outs = []
    chunk = 5 * C.FRAME_SIZE
    for i in range(4):
        pcm, state = pipeline.enhance_chunk(
            model, sig[:, i * chunk:(i + 1) * chunk], state, device=CPU)
        outs.append(pcm.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full.numpy(),
                               atol=2e-5)


def test_lookahead_delay_and_flush(model):
    """Output frame t is input frame t-(FRAME_LOOKAHEAD+1); flushing with
    zeros drains the tail (denoise.cpp:402)."""
    sig = _noisy(1, 12, seed=3)
    state = pipeline.init_pipeline_state(1, device=CPU)
    out1, state = pipeline.enhance_chunk(model, sig, state, device=CPU)
    delay = C.FRAME_LOOKAHEAD * C.FRAME_SIZE
    np.testing.assert_allclose(out1[0, :delay].numpy(), 0.0, atol=1e-6)
    assert out1[0, delay:delay + C.FRAME_SIZE].abs().max() > 0
    flush = np.zeros((1, pipeline.flush_frames() * C.FRAME_SIZE), np.float32)
    out2, _ = pipeline.enhance_chunk(model, flush, state, device=CPU)
    assert out2.abs().max() > 0.0


def test_enhance_utterance_equals_batch_row(model):
    sig = _noisy(2, 8, seed=4)
    batch, _ = pipeline.enhance_chunk(
        model, sig, pipeline.init_pipeline_state(2, device=CPU), device=CPU)
    one = pipeline.enhance_utterance(model, sig[1], device=CPU)
    np.testing.assert_allclose(one.numpy(), batch[1].numpy(), atol=2e-5)


@pytest.mark.parametrize("entry", ["enhance_chunk", "enhance_utterance",
                                   "init_pipeline_state", "server"])
def test_entry_points_raise_without_a_card(model, monkeypatch, entry):
    """With no card and no device='cpu' the entry points refuse to run on
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig = _noisy(1, 2, seed=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "enhance_chunk":
            pipeline.enhance_chunk(model, sig, pipeline.init_pipeline_state(
                1, device=CPU))
        elif entry == "enhance_utterance":
            pipeline.enhance_utterance(model, sig[0])
        elif entry == "init_pipeline_state":
            pipeline.init_pipeline_state(1)
        else:
            StreamingServer(model, capacity=2)


def test_state_on_another_device_raises(model):
    state = pipeline.init_pipeline_state(1, device=CPU)
    meta = state._replace(synthesis_mem=torch.zeros(1, C.FRAME_SIZE,
                                                    device="meta"))
    with pytest.raises(ValueError):
        pipeline.enhance_chunk(model, _noisy(1, 2, seed=6), meta, device=CPU)
