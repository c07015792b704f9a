"""The port's bf16 serving tier and int16 wire against the JAX package's
serving tier (compute_dtype=bfloat16, impl='cpu'), on the CPU.

The same numpy inputs, made from seeds, go through both packages.  Bounds
(the measured error on these inputs, from a CPU run, in brackets):
  - bf16 DFT operands, f32 results: 1e-6 of full scale [3e-7]; the
    products of bf16 values are exact, only f32 summation orders differ;
  - comb bf16 store: within 1 bf16 ulp of JAX's (its einsum sums the taps
    in another order than tap order) [0 ulp];
  - serving frontend: pitch periods exact and equal to the f32 tier's;
    spectra and energies within 1e-5 of full scale [4e-7]; the coherence
    within 1e-4 absolute, as in tests/test_torch_frontend.py [3e-6];
  - model and pipeline: g/r mean abs within 0.03, the repo's bf16 bound
    (tests/test_model.py) [g 7e-5, r 1.2e-4; max 1e-3]; PCM within 3e-3 of
    full scale + 32 LSB, the repo's bf16 streaming-vs-batch bound
    (tests/test_pipeline.py) [1.9e-4 at a 0.18 peak];
  - int16 wire: within 1 LSB of the float server's C-cast output
    (tests/test_serve.py).
The servers are held against the JAX package's enhance_chunk, not its
StreamingServer (whose tick graphs a stale persistent XLA:CPU cache can
return as zeros).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu import pipeline as j_pipeline
from percepnet_tpu.features import frontend as j_frontend
from percepnet_tpu.io.flat_npz import params_from_flat as j_params_from_flat
from percepnet_tpu.io.flat_npz import params_to_flat as j_params_to_flat
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.ops import comb as j_comb
from percepnet_tpu.ops import dft as j_dft
from percepnet_tpu.utils import metrics as j_metrics
from percepnet_tpu_torch import bench_comb
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.features import frontend
from percepnet_tpu_torch.io.flat_npz import load_params, params_from_flat
from percepnet_tpu_torch.models.percepnet import init_model_state
from percepnet_tpu_torch.ops import activations, comb, dft
from percepnet_tpu_torch.serve import StreamingServer
from percepnet_tpu_torch.utils import metrics

torch.set_num_threads(2)
BF16 = torch.bfloat16
CPU = "cpu"
CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "artifacts", "exp_log1p_30000_params.npz")
B, T = 2, 16
PCM_BF16_TOL = 3e-3 + 32 / 32768          # normalized PCM
LSB_BF16_TOL = 3e-3 * 32768 + 32          # int16 PCM
GR_BF16_MEAN_TOL = 0.03


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _f32(x):
    """A bf16 JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _voiced(bsz, n_frames, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(n_frames * C.FRAME_SIZE) / C.SAMPLE_RATE
    f0 = rng.uniform(120, 240, (bsz, 1)) * (1 + 0.2 * np.sin(2 * np.pi * n))
    ph = 2 * np.pi * np.cumsum(f0, axis=-1) / C.SAMPLE_RATE
    voiced = sum(np.sin(k * ph) / k for k in range(1, 5))
    return (0.1 * voiced + 0.02 * rng.standard_normal((bsz, n.size))).astype(
        np.float32)


@pytest.fixture(scope="module")
def weights():
    """Seeded random weights on both sides (their output is loud enough
    for the PCM bounds to mean something)."""
    jp = j_model.init_params(jax.random.PRNGKey(0))
    flat = {k: np.array(v) for k, v in j_params_to_flat(jp).items()}
    return jp, flat


# --- ops ------------------------------------------------------------------

def test_dft_bf16_operands_give_f32_spectra_like_jax():
    rng = np.random.default_rng(21)
    x32 = torch.from_numpy(rng.standard_normal((2, 3, C.WINDOW_SIZE)).astype(
        np.float32))
    x = x32.to(BF16)
    jx = jnp.asarray(_f32(x)).astype(jnp.bfloat16)
    xr, xi = dft.forward_dft(x)
    jr, ji = j_dft.forward_dft(jx)
    assert xr.dtype == torch.float32 and xi.dtype == torch.float32
    assert _rel(xr, jr) <= 1e-6 and _rel(xi, ji) <= 1e-6
    # the tier rounds: the f32 transform of the unrounded frames differs
    assert _rel(xr, dft.forward_dft(x32)[0]) > 1e-5
    zr, zi = xr.to(BF16), xi.to(BF16)
    y = dft.inverse_dft(zr, zi)
    jy = j_dft.inverse_dft(jnp.asarray(_f32(zr)).astype(jnp.bfloat16),
                           jnp.asarray(_f32(zi)).astype(jnp.bfloat16))
    assert y.dtype == torch.float32 and _rel(y, jy) <= 1e-6
    assert _rel(dft.inverse_dft(xr, xi), y) > 1e-5


@pytest.mark.parametrize("bsz,t", [(1, 1), (2, 7), (2, 40)])
def test_comb_bf16_store_within_one_ulp_of_jax(bsz, t):
    rng = np.random.default_rng(100 + t)
    s_pad = rng.standard_normal((bsz, t * C.FRAME_SIZE + 5280)).astype(
        np.float32)
    period = rng.integers(60, 770, (bsz, t)).astype(np.int32)
    ref = _f32(j_comb.comb_filter_windows_batch(
        jnp.asarray(s_pad), jnp.asarray(period), 2400,
        out_dtype=jnp.bfloat16, impl="cpu"))
    s, p = torch.from_numpy(s_pad), torch.from_numpy(period)
    got = comb.comb_ref(s, p, 2400, BF16)
    assert got.dtype == BF16 and got.shape == (bsz, t, C.WINDOW_SIZE)
    got = _f32(got)
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    assert np.all(np.abs(got - ref) <= np.where(mag > 0, ulp, 0.0))
    # the dispatcher's CPU tier is the plain version: its f32 sum rounded
    via = comb.comb_filter_windows_batch(s, p, 2400, out_dtype=BF16)
    assert torch.equal(via.view(torch.int16),
                       comb.comb_ref(s, p, 2400).to(BF16).view(torch.int16))


def test_bench_comb_inputs_bound_and_card_check():
    s_pad, period = bench_comb.make_inputs(3, 5, device=CPU)
    assert s_pad.shape == (3, 5 * C.FRAME_SIZE + 5280)
    assert period.dtype == torch.int32
    assert not s_pad[:, :5280].any() and s_pad[:, 5280:].any()
    assert int(period.min()) >= 60 and int(period.max()) <= 769
    f32_ms, by = bench_comb.bound(64, 100, 100 * 480 + 5280, torch.float32)
    bf16_ms, _ = bench_comb.bound(64, 100, 100 * 480 + 5280, BF16)
    assert by == "bytes" and 0 < bf16_ms < f32_ms
    with pytest.raises(ValueError):        # the kernels need the card
        bench_comb.check(s_pad, period)


def test_bench_comb_exits_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_comb.main(["--batch", "2", "--frames", "2"]) == 2


# --- frontend -------------------------------------------------------------

@pytest.fixture(scope="module")
def fronts():
    sig = _voiced(B, T, seed=7)
    ref, ref_state = j_frontend.analyze_batch(jnp.asarray(sig), serving=True,
                                              impl="cpu")
    out, state = frontend.analyze_batch(torch.from_numpy(sig), serving=True)
    f32, _ = frontend.analyze_batch(torch.from_numpy(sig))
    return ({k: np.asarray(v) for k, v in ref.items()}, ref_state,
            {k: v.numpy() for k, v in out.items()}, state,
            {k: v.numpy() for k, v in f32.items()})


def test_serving_frontend_periods_exact(fronts):
    ref, ref_state, out, state, f32 = fronts
    np.testing.assert_array_equal(out["period"], ref["period"])
    np.testing.assert_array_equal(out["period"], f32["period"])
    np.testing.assert_array_equal(out["silence"], ref["silence"])
    np.testing.assert_array_equal(state.period.numpy(),
                                  np.asarray(ref_state.period))


@pytest.mark.parametrize("key", ["xr", "xi", "pr", "pi", "ex", "ep",
                                 "ey_look", "gain", "corr"])
def test_serving_frontend_continuous_outputs_match_jax(fronts, key):
    ref, _, out, _, _ = fronts
    assert out[key].dtype == np.float32
    assert _rel(out[key], ref[key]) <= 1e-5, key


def test_serving_frontend_features_match_jax(fronts):
    ref, _, out, _, f32 = fronts
    f, r = out["features"], ref["features"]
    assert _rel(f[..., :34], r[..., :34]) <= 1e-5
    assert np.abs(out["exp"] - ref["exp"]).max() <= 1e-4
    assert np.abs(f[..., 34:68] - r[..., 34:68]).max() <= \
        1e-4 * C.FEATURE_SCALE
    # the tier differs from the f32 parity path where bf16 enters
    assert _rel(out["xr"], f32["xr"]) > 1e-5
    assert _rel(out["pr"], f32["pr"]) > 1e-5


# --- model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint():
    with np.load(CHECKPOINT) as data:
        return dict(data)


def _features(bsz, t, seed):
    rng = np.random.default_rng(seed)
    f = rng.random((bsz, t, C.NB_FEATURES)).astype(np.float32)
    f[..., :68] *= 300.0
    f[..., 68] = rng.integers(60, 769, (bsz, t)) / C.PITCH_T_NORM
    return f


def test_model_bf16_matches_jax(checkpoint):
    """Round-5 checkpoint, log1p features, bf16 compute."""
    feats = _features(2, 20, seed=31)
    jp = j_params_from_flat(j_model.init_params(jax.random.PRNGKey(0)),
                            checkpoint)
    jg, jr, _ = j_model.forward(jp, jnp.asarray(feats),
                                compute_dtype=jnp.bfloat16,
                                log1p_features=True)
    model = params_from_flat(checkpoint)
    with torch.no_grad():
        g, r, state = model(torch.from_numpy(feats), compute_dtype=BF16,
                            log1p_features=True)
    assert g.dtype == torch.float32 and r.dtype == torch.float32
    assert all(t.dtype == BF16 for t in state)
    assert next(model.parameters()).dtype == torch.float32
    assert np.abs(g.numpy() - np.asarray(jg)).mean() <= GR_BF16_MEAN_TOL
    assert np.abs(r.numpy() - np.asarray(jr)).mean() <= GR_BF16_MEAN_TOL


def test_model_bf16_state_carry_and_dtype_check(checkpoint):
    feats = torch.from_numpy(_features(2, 12, seed=32))
    model = params_from_flat(checkpoint)
    with torch.no_grad():
        g_all, _, st_all = model(feats, compute_dtype=BF16)
        g_a, _, st = model(feats[:, :5], compute_dtype=BF16)
        g_b, _, st = model(feats[:, 5:], st, compute_dtype=BF16)
        with pytest.raises(ValueError):
            model(feats, init_model_state(2, torch.device(CPU)),
                  compute_dtype=BF16)
        # the C-table activations keep the bf16 state too
        g_c, _, st_c = model(feats, compute_dtype=BF16,
                             act_tanh=activations.tansig_approx,
                             act_sigmoid=activations.sigmoid_approx)
        # a module already in bf16 (the server's copy) gives the same
        g_16, _, _ = model.to(BF16)(feats, compute_dtype=BF16)
    got = torch.cat([g_a, g_b], dim=1)
    assert (got - g_all).abs().mean().item() <= GR_BF16_MEAN_TOL
    assert all(t.dtype == BF16 for t in st)
    assert g_c.dtype == torch.float32 and all(t.dtype == BF16 for t in st_c)
    assert (g_c - g_all).abs().mean().item() <= GR_BF16_MEAN_TOL
    assert torch.equal(g_16, g_all)


# --- pipeline -------------------------------------------------------------

def test_enhance_chunk_bf16_matches_jax(weights):
    jp, flat = weights
    sig = (0.1 * np.random.default_rng(41).standard_normal(
        (B, T * C.FRAME_SIZE))).astype(np.float32)
    j_pcm, _, (jg, jr) = j_pipeline.enhance_chunk(
        jp, jnp.asarray(sig), j_pipeline.init_pipeline_state(
            B, jnp.bfloat16), return_gr=True, impl="cpu",
        compute_dtype=jnp.bfloat16)
    pcm, state, (g, r) = pipeline.enhance_chunk(
        params_from_flat(flat), sig, pipeline.init_pipeline_state(
            B, model_dtype=BF16, device=CPU), return_gr=True, device=CPU,
        compute_dtype=BF16)
    assert pcm.dtype == torch.float32 and state.model.h1.dtype == BF16
    assert np.abs(np.asarray(j_pcm)).max() > 0.05
    assert np.abs(pcm.numpy() - np.asarray(j_pcm)).max() <= PCM_BF16_TOL
    assert np.abs(g.numpy() - np.asarray(jg)).mean() <= GR_BF16_MEAN_TOL
    assert np.abs(r.numpy() - np.asarray(jr)).mean() <= GR_BF16_MEAN_TOL


def test_enhance_chunk_bf16_streaming_equals_batch(weights):
    """Chunks of 4 frames with carried bf16 state against one call."""
    model = params_from_flat(weights[1])
    sig = (0.1 * np.random.default_rng(42).standard_normal(
        (1, T * C.FRAME_SIZE))).astype(np.float32)
    kw = dict(device=CPU, compute_dtype=BF16)
    full, _ = pipeline.enhance_chunk(model, sig, pipeline.init_pipeline_state(
        1, model_dtype=BF16, device=CPU), **kw)
    state = pipeline.init_pipeline_state(1, model_dtype=BF16, device=CPU)
    parts, chunk = [], 4 * C.FRAME_SIZE
    for i in range(T // 4):
        pcm, state = pipeline.enhance_chunk(
            model, sig[:, i * chunk:(i + 1) * chunk], state, **kw)
        parts.append(pcm.numpy())
    assert np.abs(np.concatenate(parts, 1) - full.numpy()).max() <= \
        PCM_BF16_TOL
    one = pipeline.enhance_utterance(model, sig[0], **kw)
    np.testing.assert_array_equal(one.numpy(), full[0].numpy())


def test_compute_dtype_float32_stays_on_parity_path(weights):
    model = params_from_flat(weights[1])
    sig = (0.1 * np.random.default_rng(43).standard_normal(
        (1, 6 * C.FRAME_SIZE))).astype(np.float32)
    a, _ = pipeline.enhance_chunk(model, sig, pipeline.init_pipeline_state(
        1, device=CPU), device=CPU)
    b, _ = pipeline.enhance_chunk(model, sig, pipeline.init_pipeline_state(
        1, device=CPU), device=CPU, compute_dtype=torch.float32)
    assert torch.equal(a, b)


# --- server ---------------------------------------------------------------

def _pcm16(n_frames, seed):
    rng = np.random.default_rng(seed)
    return (20000 * 0.3 * rng.standard_normal(n_frames * C.FRAME_SIZE)
            ).astype(np.int16)


def _serve(srv, sid, pcm):
    out = []
    for t in range(pcm.size // C.FRAME_SIZE):
        srv.submit(sid, pcm[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        out.append(srv.step()[sid])
    return np.concatenate(out)


def test_int16_wire_matches_float_server_truncated(weights):
    """io_int16 == the float server with /32768 in and the C cast out,
    within 1 LSB (tests/test_serve.py:test_server_int16_wire)."""
    model = params_from_flat(weights[1])
    pcm16 = _pcm16(6, seed=51)
    srv_f = StreamingServer(model, capacity=2, device=CPU)
    srv_i = StreamingServer(model, capacity=2, io_int16=True, device=CPU)
    out_f = _serve(srv_f, srv_f.attach(), pcm16.astype(np.float32) / 32768)
    out_i = _serve(srv_i, srv_i.attach(), pcm16)
    assert out_i.dtype == np.int16
    expect = np.trunc(np.clip(out_f.astype(np.float64) * 32768.0,
                              -32768, 32767))
    assert np.abs(out_f).max() > 0.01
    assert np.max(np.abs(out_i.astype(np.float64) - expect)) <= 1.0


def test_bf16_int16_server_matches_jax_serving_tier(weights):
    """StreamingServer(model_dtype=bf16, io_int16=True) against JAX's
    batched bf16 enhance_chunk, truncated alike: within 3e-3 of full scale
    + 32 LSB."""
    jp, flat = weights
    model = params_from_flat(flat)
    pcm16 = _pcm16(T, seed=52)
    srv = StreamingServer(model, capacity=B, model_dtype=BF16,
                          io_int16=True, device=CPU)
    assert next(model.parameters()).dtype == torch.float32
    assert next(srv.model.parameters()).dtype == BF16
    assert srv._states[0].model.h1.dtype == BF16
    sid = srv.attach()
    got = _serve(srv, sid, pcm16)
    full = np.zeros((B, pcm16.size), np.float32)
    full[sid] = pcm16 / 32768.0
    j_pcm, _ = j_pipeline.enhance_chunk(
        jp, jnp.asarray(full), j_pipeline.init_pipeline_state(
            B, jnp.bfloat16), impl="cpu", compute_dtype=jnp.bfloat16)
    expect = np.trunc(np.clip(np.asarray(j_pcm[sid], np.float64) * 32768.0,
                              -32768, 32767))
    assert got.dtype == np.int16 and np.abs(expect).max() > 1000
    assert np.abs(got.astype(np.float64) - expect).max() <= LSB_BF16_TOL


def test_bf16_server_reattach_starts_from_zero_state(weights):
    model = params_from_flat(weights[1])
    pcm16 = _pcm16(6, seed=53)
    srv = StreamingServer(model, capacity=2, model_dtype=BF16,
                          io_int16=True, device=CPU)
    a = srv.attach()
    first = _serve(srv, a, pcm16)
    srv.detach(a)
    b = srv.attach()
    assert b == a
    assert all(not t[b].any() for t in srv._states[0].model)
    assert srv._states[0].model.h1.dtype == BF16
    np.testing.assert_array_equal(_serve(srv, b, pcm16), first)


# --- metrics --------------------------------------------------------------

@pytest.mark.parametrize("seed,noise", [(61, 0.3), (62, 1.0)])
def test_metrics_equal_jax_package(seed, noise):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal(2 * C.SAMPLE_RATE)
    est = clean + noise * rng.standard_normal(clean.size)
    assert metrics.si_sdr_db(clean, est) == j_metrics.si_sdr_db(clean, est)
    assert metrics.stoi(clean, est) == j_metrics.stoi(clean, est)


def test_checkpoint_serves_in_bf16():
    """The round-5 checkpoint at its full widths through the bf16 int16
    server: finite int16 output, state in bf16."""
    model = load_params(CHECKPOINT)
    srv = StreamingServer(model, capacity=2, model_dtype=BF16,
                          io_int16=True, log1p_features=True, device=CPU)
    out = _serve(srv, srv.attach(), _pcm16(8, seed=54))
    assert out.dtype == np.int16 and out.shape == (8 * C.FRAME_SIZE,)
    assert sum(p.numel() for p in srv.model.parameters()) == 7_962_564
