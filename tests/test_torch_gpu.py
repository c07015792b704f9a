"""Card-only tests of the PyTorch/CUDA port (marker `gpu`).

Each test asks the `cuda` fixture for the card and skips without one, so
every process collects the same tests.  The file imports neither JAX nor
the JAX package: the machine with the card has no JAX, and the tests hold
the kernel against its plain PyTorch version and the card against the
port's own CPU run.  On that machine, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from percepnet_tpu_torch import bench_comb
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.ops import comb
from percepnet_tpu_torch.serve import StreamingServer

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    before = comb.launches["windows_f32"]
    got = comb.comb_filter_windows_batch(s, p, 2400)
    torch.cuda.synchronize()
    assert comb.launches["windows_f32"] == before + 1
    ref = comb.comb_ref(s, p, 2400)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-6


def _bits(x):
    return x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16
                               else torch.int32)


@pytest.mark.parametrize("bsz,t", [(64, 100), (64, 1), (3, 37)])
def test_comb_bf16_store_is_rounded_plain_version(cuda, bsz, t):
    """The bf16 store equals comb_ref(..., bf16) bit for bit (the property
    check_tpu.py check 1 pins on the TPU)."""
    s, p = _comb_inputs(bsz, t, bsz + t, cuda)
    before = comb.launches["windows_bf16"]
    got = comb.comb_filter_windows_batch(s, p, 2400,
                                         out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert comb.launches["windows_bf16"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (bsz, t, 960)
    ref = comb.comb_ref(s, p, 2400, torch.bfloat16)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("bsz,t", [(64, 100), (64, 1), (3, 37)])
def test_comb_rows_kernel_equals_v1_bit_for_bit(cuda, bsz, t):
    """v2 (row layout): f32 == v1 f32 and bf16 == rn(its own f32), bit
    for bit; the padded row's tail is zero."""
    s, p = _comb_inputs(bsz, t, bsz + t, cuda)
    v1 = comb.comb_cuda(s, p, 2400)
    v2 = comb.comb_cuda_rows(s, p, 2400)
    v2_16 = comb.comb_cuda_rows(s, p, 2400, torch.bfloat16)
    assert v2.shape == (bsz, t, 960) and v2.stride()[1] == comb.ROW_LEN
    assert torch.equal(_bits(v2), _bits(v1))
    assert torch.equal(_bits(v2_16), _bits(v2.to(torch.bfloat16)))
    rows = v2_16.as_strided((bsz, t, comb.ROW_LEN), v2_16.stride())
    assert not rows[..., 960:].abs().max().item()


def _edge_case(case, device):
    """Inputs and the tilings to launch them in: the edge-period input
    (max_period and the NaN frame past it in one tile, -1, 60, a ragged
    last tile, a tile with nothing to stage), a ragged last tile, B = 1
    and T = 1, and 4 rows of 512 x 200 in that shape's own tiling."""
    if case == "edge":
        s, p = bench_comb.edge_inputs(device=device)
        return s, p, (None, (8, 1), (12, 1), (3, 3), (1, 2))
    if case == "ragged":
        s, p = _comb_inputs(5, 13, 3, device)
        return s, p, (None, (8, 1), (12, 1), (5, 2), (4, 8))
    if case == "b1t1":
        s, p = _comb_inputs(1, 1, 4, device)
        return s, p, (None, (1, 1), (1, 8))
    s, p = bench_comb.make_inputs(512, 200, device=device)
    s, p = bench_comb.check_slice(s, p)
    return s, p, (None, comb.tile_grid(512, 200))


@pytest.mark.parametrize("case", ["edge", "ragged", "b1t1", "512x200_rows4"])
def test_comb_kernels_bit_exact_on_edge_inputs(cuda, case):
    """Every kernel and store, in every tiling, equals the plain version
    bit for bit; NaN frames exactly where the period is out of range."""
    s, p, grids = _edge_case(case, cuda)
    checks = bench_comb.check(s, p, grids)
    assert bench_comb.all_exact(checks), checks
    max_p = comb.max_period(p.shape[1], s.shape[1], 2400)
    bad = (p < 0) | (p > max_p)
    for out in (comb.comb_cuda(s, p, 2400),
                comb.comb_cuda(s, p, 2400, torch.bfloat16),
                comb.comb_cuda_rows(s, p, 2400),
                comb.comb_cuda_rows(s, p, 2400, torch.bfloat16)):
        assert torch.equal(torch.isnan(out).all(-1), bad)
        assert torch.isfinite(out[~bad]).all()


def test_comb_kernel_rejects_what_it_does_not_take(cuda):
    s, p = _comb_inputs(2, 4, 0, cuda)
    with pytest.raises(TypeError):
        comb.comb_cuda(s.double(), p, 2400)
    with pytest.raises(TypeError):
        comb.comb_cuda(s, p.long(), 2400)
    with pytest.raises(ValueError):
        comb.comb_cuda(s.t().contiguous().t(), p, 2400)
    with pytest.raises(TypeError):
        comb.comb_cuda(s, p, 2400, torch.float16)
    with pytest.raises(ValueError):
        comb.comb_filter_windows_batch(s, p, 2400, impl="ref")


def test_comb_kernel_out_of_range_period_gives_nan_frame(cuda):
    s, p = _comb_inputs(2, 3, 1, cuda)
    p[1, 2] = 900
    for out in (comb.comb_cuda(s, p, 2400),
                comb.comb_cuda(s, p, 2400, torch.bfloat16),
                comb.comb_cuda_rows(s, p, 2400)):
        assert torch.isnan(out[1, 2]).all()
        assert torch.isfinite(out[0]).all() and \
            torch.isfinite(out[1, :2]).all()


def test_enhance_chunk_on_card_matches_cpu(cuda):
    """Card vs CPU within the off-CPU bounds of tests/test_nn_parity.py;
    the card's run goes through the comb kernel."""
    sig = _noisy(2, 20, seed=7)
    model = PercepNet(torch.Generator().manual_seed(0))
    comb.reset_launches()
    pcm, _, (g, r) = pipeline.enhance_chunk(
        PercepNet(torch.Generator().manual_seed(0)).to(cuda), sig,
        pipeline.init_pipeline_state(2), return_gr=True)
    assert comb.launches["windows_f32"] > 0
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


def test_bf16_tier_on_card_matches_cpu(cuda):
    """The bf16 serving tier on the card launches the bf16 comb kernel and
    stays within the bf16 bounds of the port's CPU run: g/r mean abs
    <= 0.03 (tests/test_model.py), PCM <= 3e-3 + 32/32768 of full scale
    (tests/test_pipeline.py); pitch periods equal the f32 tier's."""
    bf16 = torch.bfloat16
    sig = _noisy(2, 20, seed=9)
    model = PercepNet(torch.Generator().manual_seed(0))
    comb.reset_launches()
    pcm, _, (g, r) = pipeline.enhance_chunk(
        PercepNet(torch.Generator().manual_seed(0)).to(cuda), sig,
        pipeline.init_pipeline_state(2, model_dtype=bf16), return_gr=True,
        compute_dtype=bf16)
    assert comb.launches["windows_bf16"] > 0
    assert comb.launches["windows_f32"] == 0
    pcm_c, _, (g_c, r_c) = pipeline.enhance_chunk(
        model, sig, pipeline.init_pipeline_state(2, model_dtype=bf16,
                                                 device="cpu"),
        return_gr=True, device="cpu", compute_dtype=bf16)
    assert (g.cpu() - g_c).abs().mean().item() <= 0.03
    assert (r.cpu() - r_c).abs().mean().item() <= 0.03
    assert (pcm.cpu() - pcm_c).abs().max().item() <= 3e-3 + 32 / 32768


def test_bf16_int16_server_on_card_matches_batch(cuda):
    """StreamingServer(model_dtype=bf16, io_int16=True) against one
    batched bf16 enhance_chunk, truncated alike: within 3e-3 of full
    scale + 32 LSB (tests/test_pipeline.py's bf16 streaming bound)."""
    bf16 = torch.bfloat16
    model = PercepNet(torch.Generator().manual_seed(0)).to(cuda)
    srv = StreamingServer(model, capacity=4, model_dtype=bf16,
                          io_int16=True)
    assert next(model.parameters()).dtype == torch.float32
    pcm16 = (_noisy(1, 10, seed=10)[0] * 32768).astype(np.int16)
    full = np.zeros((4, pcm16.size), np.float32)
    sid = srv.attach()
    full[sid] = pcm16 / 32768.0
    ref, _ = pipeline.enhance_chunk(
        model.to(bf16), full, pipeline.init_pipeline_state(
            4, model_dtype=bf16), compute_dtype=bf16)
    ref = torch.clamp(ref * 32768, -32768, 32767).to(torch.int16)
    got = []
    for t in range(10):
        srv.submit(sid, pcm16[t * C.FRAME_SIZE:(t + 1) * C.FRAME_SIZE])
        got.append(srv.step()[sid])
    got = np.concatenate(got)
    assert got.dtype == np.int16
    err = np.abs(got.astype(np.int32) - ref[sid].cpu().numpy()).max()
    assert err <= 3e-3 * 32768 + 32


CHECKPOINT = os.path.join(ROOT, "artifacts", "exp_log1p_30000_params.npz")
FEATGEN = os.path.join(ROOT, "tests", "goldens", "featgen.npz")


def test_enhance_cli_on_card_matches_enhance_chunk(cuda, tmp_path):
    """`python -m percepnet_tpu_torch enhance` on the card (its default)
    writes what one enhance_chunk on the card gives for the file plus the
    flush frames, first frame dropped and C-cast: within 1 LSB."""
    from percepnet_tpu_torch import __main__ as dispatcher
    from percepnet_tpu_torch.io.flat_npz import load_params
    with np.load(FEATGEN) as g:
        noisy = g["noisy16"][: 30 * C.FRAME_SIZE]
    src, dst = str(tmp_path / "in.pcm"), str(tmp_path / "out.pcm")
    noisy.astype("<i2").tofile(src)
    comb.reset_launches()
    dispatcher.main(["enhance", src, dst, "--weights", CHECKPOINT,
                     "--log1p", "--raw-scale"])
    assert comb.launches["windows_f32"] > 0
    sig = np.zeros((1, (30 + pipeline.flush_frames()) * C.FRAME_SIZE),
                   np.float32)
    sig[0, : noisy.size] = noisy
    ref, _ = pipeline.enhance_chunk(load_params(CHECKPOINT).to(cuda), sig,
                                    pipeline.init_pipeline_state(1),
                                    log1p_features=True)
    ref = np.trunc(np.clip(ref[0, C.FRAME_SIZE : noisy.size].cpu().numpy(),
                           -32768, 32767))
    got = np.fromfile(dst, "<i2").astype(np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1


def test_featgen_on_card_periods_match_golden(cuda, tmp_path):
    """`featgen` on the card (f32, through the comb kernel) gives the C
    binary's pitch periods on the golden clip, frame for frame."""
    from percepnet_tpu_torch import __main__ as dispatcher
    with np.load(FEATGEN) as g:
        clean, noisy, ref = g["clean16"], g["noisy16"], g["records"]
    paths = [str(tmp_path / n) for n in ("c.pcm", "n.pcm", "out.f32")]
    clean.astype("<i2").tofile(paths[0])
    noisy.astype("<i2").tofile(paths[1])
    comb.reset_launches()
    dispatcher.main(["featgen", *paths[:2], "200", paths[2]])
    assert comb.launches["windows_f32"] > 0
    rec = np.fromfile(paths[2], "<f4").reshape(-1, C.RECORD_DIM)
    np.testing.assert_array_equal(np.round(rec[:, 68] * 588),
                                  np.round(ref[:, 68] * 588))


@pytest.mark.parametrize("start", ["checkpoint", "random_init"])
def test_train_step_on_card_matches_cpu(cuda, start):
    """One training step (remat on) with log1p features on the golden
    records, 2 x 100 with x30 on columns 0:68, on the card against the
    port's CPU, with chip_smoke.py's bounds: loss 1e-4 relative, each
    gradient leaf within 1e-2 of its max |g|, cosine over all leaves >=
    0.9999; the step leaves the counters as a finite step does.  From
    the round-5 checkpoint as it is; from a random init (seed 0) with
    every forward product rounded once from f64 on both devices, since
    there the input stack's f32 gradient depends on the GEMMs' summation
    order (train/numerics.py).  TF32 stays off for the f32 step."""
    from percepnet_tpu_torch.io.flat_npz import load_params
    from percepnet_tpu_torch.train import state as ts
    from percepnet_tpu_torch.train.numerics import ExactProducts
    assert not torch.backends.cuda.matmul.allow_tf32
    with np.load(FEATGEN) as g:
        rec = g["records"].astype(np.float32)
    rec[:, :68] *= C.FEATURE_SCALE
    x = torch.from_numpy(rec[:, :70].reshape(2, 100, 70).copy())
    y = torch.from_numpy(rec[:, 70:].reshape(2, 100, 68).copy())
    got = {}
    for dev in ("cpu", cuda):
        model = (load_params(CHECKPOINT) if start == "checkpoint" else
                 PercepNet(torch.Generator().manual_seed(0))).to(dev)
        with ExactProducts() if start == "random_init" else \
                contextlib.nullcontext():
            loss = ts.loss_fn(model, x.to(dev), y.to(dev),
                              log1p_features=True)
            grads = torch.autograd.grad(loss, ts.parameters(model))
            got[str(dev)] = (loss.item(), [g.cpu() for g in grads])
            opt = ts.make_optimizer(1e-4)
            state = ts.init_train_state(model, opt)
            ts.train_step(state, x.to(dev), y.to(dev), opt,
                          log1p_features=True)
        assert int(state.step) == 1
        assert int(state.opt_state["inner_state/0/count"]) == 1
        assert bool(state.opt_state["last_finite"])
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got["cuda"]
    assert abs(l_card - l_cpu) <= 1e-4 * l_cpu
    for a, b in zip(g_cpu, g_card):
        assert (a - b).abs().max() <= 1e-2 * a.abs().max()
    a, b = torch.cat([g.reshape(-1) for g in g_cpu]), \
        torch.cat([g.reshape(-1) for g in g_card])
    assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.9999


@pytest.mark.parametrize("tier", ["f32", "bf16"])
def test_one_shard_mesh_server_on_card_equals_plain_server(cuda, tier):
    """StreamingServer(mesh=make_mesh(['cuda:0'])) launches B1 and gives
    the plain server's output bit for bit (same batch, same calls), on
    the int16 wire; a 2-shard mesh on the one card launches B1 once per
    shard per tick at capacity / 2."""
    from percepnet_tpu_torch.parallel import make_mesh
    dtype = torch.bfloat16 if tier == "bf16" else None
    model = PercepNet(torch.Generator().manual_seed(0)).to(cuda)
    pcm16 = np.trunc(np.clip(_noisy(2, 8, seed=11) * 32768, -32768,
                             32767)).astype(np.int16)
    outs = []
    for mesh in (None, ["cuda:0"], ["cuda:0", "cuda:0"]):
        kw = {"mesh": make_mesh(mesh)} if mesh else {}
        srv = StreamingServer(model, capacity=4, model_dtype=dtype,
                              io_int16=True, **kw)
        sids = [srv.attach() for _ in range(2)]
        comb.reset_launches()
        got = {sid: [] for sid in sids}
        for t in range(8):
            for i, sid in enumerate(sids):
                srv.submit(sid, pcm16[i, t * 480:(t + 1) * 480])
            for sid, frame in srv.step().items():
                got[sid].append(frame)
        store = "bf16" if tier == "bf16" else "f32"
        assert comb.launches[f"windows_{store}"] == 8 * len(mesh or [1])
        if mesh and len(mesh) == 2:
            assert {s[1] for s in comb.launch_shapes} == {2}
        outs.append(np.stack([np.concatenate(got[s]) for s in sids]))
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[1], outs[0])


def test_nccl_world_one_train_step_equals_plain_step(cuda):
    """One training step in an NCCL group of one (the gradient all-reduce
    and the loss's mean over one rank) leaves the parameters, the
    optimizer state and the loss bit for bit as the step without a
    group."""
    import socket
    from percepnet_tpu_torch.parallel import mesh as pm
    from percepnet_tpu_torch.train import state as ts
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 20, 70)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.uniform(0.05, 0.95, (2, 20, 68)).astype(
        np.float32)).to(cuda)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    runs = []
    for group in (False, True):
        if group:
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            pm.init_distributed(f"localhost:{port}", 1, 0, "cuda")
        try:
            assert pm.process_count() == 1 and pm.in_group() == group
            opt = ts.make_optimizer(1e-3)
            state = ts.init_train_state(
                PercepNet(torch.Generator().manual_seed(0)).to(cuda), opt)
            loss = ts.train_step(state, x, y, opt)
            runs.append((loss.item(), [p.detach().cpu().clone() for p in
                                       ts.parameters(state.model)],
                         {k: v.cpu() for k, v in state.opt_state.items()}))
        finally:
            if group:
                pm.shutdown()
    (l0, p0, o0), (l1, p1, o1) = runs
    assert l0 == l1
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    assert o0.keys() == o1.keys()
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k


def test_profile_pipeline_stages_on_card(cuda):
    """tools.profile_pipeline on the card: the comb stage (and each full
    call) launches B1 once per call, no other stage launches it; every
    stage has kernels, a wall time at least its device time and a busy
    share in (0, 1]."""
    from percepnet_tpu_torch.tools import profile_pipeline
    for serving in (False, True):
        rows = {r["name"]: r for r in profile_pipeline.run(
            16, 20, 2, serving, cuda)}
        assert list(rows) == list(profile_pipeline.STAGES)
        for name, row in rows.items():
            want = 1 if name == "comb" or name.startswith("full") else 0
            what = (serving, name, row)
            assert row["b1_launches"] == want, what
            assert row["launches"] > 0 and row["device_ms"] > 0, what
            assert row["wall_ms"] >= row["device_ms"], what
            assert 0 < row["busy_share"] <= 1, what


def test_quality_gate_on_card_matches_cpu(cuda, tmp_path):
    """tools.quality_gate on one 20 s holdout pair (tools/synth_dns.py,
    run as a subprocess) in both tiers: the card's f32 output is within
    the card-vs-CPU PCM bound (5e-4 of full scale) of the port's CPU run,
    and the report has both tiers."""
    import json
    import subprocess
    import sys
    from percepnet_tpu_torch.tools import quality_gate
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "synth_dns.py"),
                    str(tmp_path / "h"), "--pairs", "1", "--seconds", "20",
                    "--seed", "999", "--start-index", "90000"], check=True,
                   timeout=300)
    reports, outs = {}, {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            quality_gate.main([
                "--weights", os.path.join(ROOT, "artifacts",
                                          "exp_log1p_30000_params.npz"),
                "--clean-dir", str(tmp_path / "h" / "clean"),
                "--noisy-dir", str(tmp_path / "h" / "noisy"), "--log1p",
                "--limit", "1", "--out-dir", str(tmp_path / dev),
                "--device", dev])
        reports[dev] = json.loads(buf.getvalue().strip().splitlines()[-1])
        outs[dev] = np.fromfile(tmp_path / dev / "f32" / "fileid_90000.pcm",
                                "<i2").astype(np.float64)
    assert reports["cuda"]["pairs"] == 1 and "bf16" in reports["cuda"]
    assert outs["cuda"].shape == outs["cpu"].shape
    assert np.abs(outs["cuda"]).max() > 0
    assert np.abs(outs["cuda"] - outs["cpu"]).max() / 32768 <= 5e-4
