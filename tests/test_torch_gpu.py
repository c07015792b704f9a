"""Card-only tests of the PyTorch/CUDA port (marker `gpu`).

Each test asks the `cuda` fixture for the card and skips without one, so
every process collects the same tests.  The file imports neither JAX nor
the JAX package: the machine with the card has no JAX, and the tests hold
the kernel against its plain PyTorch version and the card against the
port's own CPU run.  On that machine, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.ops import comb
from percepnet_tpu_torch.serve import StreamingServer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _comb_inputs(bsz, t, seed, device):
    rng = np.random.default_rng(seed)
    s_pad = rng.standard_normal((bsz, t * C.FRAME_SIZE + 5280)).astype(
        np.float32)
    period = rng.integers(60, 770, (bsz, t)).astype(np.int32)
    return (torch.from_numpy(s_pad).to(device),
            torch.from_numpy(period).to(device))


def _noisy(bsz, n_frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames * C.FRAME_SIZE) / C.SAMPLE_RATE
    tone = 0.1 * np.sin(2 * np.pi * rng.uniform(120, 300, (bsz, 1)) * t)
    return (tone + 0.05 * rng.standard_normal(tone.shape)).astype(np.float32)


@pytest.mark.parametrize("bsz,t", [(64, 100), (64, 1), (3, 37)])
def test_comb_kernel_matches_plain_version(cuda, bsz, t):
    """The kernel rounds as the plain version does: equal to 1e-6 of the
    output's scale (bit for bit in practice)."""
    s, p = _comb_inputs(bsz, t, bsz + t, cuda)
    before = comb.launches
    got = comb.comb_filter_windows_batch(s, p, 2400)
    torch.cuda.synchronize()
    assert comb.launches == before + 1
    ref = comb.comb_ref(s, p, 2400)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-6


def test_comb_kernel_rejects_what_it_does_not_take(cuda):
    s, p = _comb_inputs(2, 4, 0, cuda)
    with pytest.raises(TypeError):
        comb.comb_cuda(s.double(), p, 2400)
    with pytest.raises(TypeError):
        comb.comb_cuda(s, p.long(), 2400)
    with pytest.raises(ValueError):
        comb.comb_cuda(s.t().contiguous().t(), p, 2400)
    with pytest.raises(ValueError):
        comb.comb_filter_windows_batch(s, p, 2400, impl="ref")


def test_comb_kernel_out_of_range_period_gives_nan_frame(cuda):
    s, p = _comb_inputs(2, 3, 1, cuda)
    p[1, 2] = 900
    out = comb.comb_cuda(s, p, 2400)
    assert torch.isnan(out[1, 2]).all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[1, :2]).all()


def test_enhance_chunk_on_card_matches_cpu(cuda):
    """Card vs CPU within the off-CPU bounds of tests/test_nn_parity.py;
    the card's run goes through the comb kernel."""
    sig = _noisy(2, 20, seed=7)
    model = PercepNet(torch.Generator().manual_seed(0))
    comb.launches = 0
    pcm, _, (g, r) = pipeline.enhance_chunk(
        PercepNet(torch.Generator().manual_seed(0)).to(cuda), sig,
        pipeline.init_pipeline_state(2), return_gr=True)
    assert comb.launches > 0
    pcm_c, _, (g_c, r_c) = pipeline.enhance_chunk(
        model, sig, pipeline.init_pipeline_state(2, device="cpu"),
        return_gr=True, device="cpu")
    assert (pcm.cpu() - pcm_c).abs().max().item() <= 5e-4
    assert (g.cpu() - g_c).abs().max().item() <= 3e-3
    assert (r.cpu() - r_c).abs().max().item() <= 3e-3


def test_server_on_card_matches_batch(cuda):
    model = PercepNet(torch.Generator().manual_seed(0)).to(cuda)
    srv = StreamingServer(model, capacity=4)
    sig = _noisy(1, 10, seed=8)[0]
    full = np.zeros((4, sig.size), np.float32)
    sid = srv.attach()
    full[sid] = sig
    ref, _ = pipeline.enhance_chunk(model, full,
                                    pipeline.init_pipeline_state(4))
    got = []
    for t in range(10):
        srv.submit(sid, sig[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        got.append(srv.step()[sid])
    np.testing.assert_allclose(np.concatenate(got), ref[sid].cpu().numpy(),
                               atol=2e-3)
