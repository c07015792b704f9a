"""The port's StreamingServer: slot lifecycle, per-stream isolation, and
per-tick output against the port's batch enhance_chunk, on the CPU."""

import jax  # noqa: F401  (JAX and torch share each test process)
import numpy as np
import pytest
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.parallel import make_mesh
from percepnet_tpu_torch.serve import StreamingServer

torch.set_num_threads(2)
CPU = "cpu"
# the per-tick (T=1) and one-shot calls reassociate the GRU inputs'
# products differently; tests/test_serve.py documents the recurrence's
# amplification of that to ~1e-4..1e-3, hence its bound
ATOL = 2e-3


@pytest.fixture(scope="module")
def model():
    return PercepNet(torch.Generator().manual_seed(0))


def _sig(n_frames, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(n_frames * C.FRAME_SIZE)).astype(
        np.float32)


def test_server_matches_batch_pipeline(model):
    srv = StreamingServer(model, capacity=3, device=CPU)
    n_frames = 8
    sig = _sig(n_frames, seed=1)
    sig3 = np.zeros((3, sig.size), np.float32)
    sig3[0] = sig
    ref, _ = pipeline.enhance_chunk(
        model, sig3, pipeline.init_pipeline_state(3, device=CPU), device=CPU)

    sid = srv.attach()
    assert sid == 0
    got = []
    for t in range(n_frames):
        srv.submit(sid, sig[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        got.append(srv.step()[sid])
    got = np.concatenate(got)
    ref0 = ref[0].numpy()
    np.testing.assert_allclose(got, ref0, atol=ATOL)
    assert np.abs(got[5 * C.FRAME_SIZE:]).max() > 0.01
    corr = np.corrcoef(got[2 * C.FRAME_SIZE:], ref0[2 * C.FRAME_SIZE:])[0, 1]
    assert corr > 0.9999, corr


def test_server_slot_lifecycle_and_isolation(model):
    srv = StreamingServer(model, capacity=2, device=CPU)
    a, b = srv.attach(), srv.attach()
    assert a != b
    with pytest.raises(RuntimeError):
        srv.attach()
    sig_a = _sig(6, seed=2)
    outs_a = []
    for t in range(6):
        srv.submit(a, sig_a[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        out = srv.step()
        outs_a.append(out[a])
        np.testing.assert_allclose(out[b], 0.0, atol=1e-6)
    assert np.abs(np.concatenate(outs_a)).max() > 0

    # detaching and re-attaching reuses the slot with FRESH state
    srv.detach(b)
    with pytest.raises(KeyError):
        srv.submit(b, sig_a[:C.FRAME_SIZE])
    c = srv.attach()
    assert c == b
    ref_solo, _ = pipeline.enhance_chunk(
        model, sig_a[None], pipeline.init_pipeline_state(1, device=CPU),
        device=CPU)
    outs_c = []
    for t in range(6):
        srv.submit(c, sig_a[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        outs_c.append(srv.step()[c])
    np.testing.assert_allclose(np.concatenate(outs_c), ref_solo[0].numpy(),
                               atol=ATOL)


def test_server_frames_per_tick(model):
    srv = StreamingServer(model, capacity=2, frames_per_tick=4, device=CPU)
    n_frames = 8
    sig = _sig(n_frames, seed=3)
    sig2 = np.zeros((2, sig.size), np.float32)
    sig2[0] = sig
    ref, _ = pipeline.enhance_chunk(
        model, sig2, pipeline.init_pipeline_state(2, device=CPU), device=CPU)
    sid = srv.attach()
    tick = 4 * C.FRAME_SIZE
    got = []
    for t in range(n_frames // 4):
        srv.submit(sid, sig[t * tick:(t + 1) * tick])
        out = srv.step()[sid]
        assert out.shape == (tick,)
        got.append(out)
    np.testing.assert_allclose(np.concatenate(got), ref[0].numpy(),
                               atol=ATOL)


def test_server_log1p_and_compat_options_reach_the_model(model):
    sig = _sig(8, seed=4)
    outs = []
    for kw in ({}, {"log1p_features": True}, {"compat": True}):
        srv = StreamingServer(model, capacity=1, device=CPU, **kw)
        sid = srv.attach()
        for t in range(8):
            srv.submit(sid, sig[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
            out = srv.step()[sid]
        outs.append(out)
    assert np.abs(outs[0]).max() > 0
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-4)


@pytest.mark.parametrize("option", [{"mesh": ("cpu",) * 3},
                                    {"model_dtype": torch.float16},
                                    {"model_dtype": torch.float64},
                                    {"frames_per_tick": 0}])
def test_server_rejects_unported_options(model, option):
    """A mesh must divide the capacity; the server serves f32 and bf16
    only, at least one frame per tick."""
    if "mesh" in option:
        option = {"mesh": make_mesh(option["mesh"])}
    else:
        option = {"device": CPU, **option}
    with pytest.raises(ValueError):
        StreamingServer(model, capacity=2, **option)
