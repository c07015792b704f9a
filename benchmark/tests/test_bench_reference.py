"""The reference against the program on the CPU at a tiny size: the same
inputs and weights through pipeline.enhance_chunk (in two chunks, state
carried) and through the reference (one pass from a fresh state)."""

import numpy as np
import pytest
import torch

from benchmark.harness import program, traffic
from benchmark.reference import percepnet_ref as R
from benchmark.tests import bench_tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("config", ["percepnet-f32", "percepnet-bf16-log1p"])
def test_reference_matches_the_program(config):
    from percepnet_tpu_torch import pipeline
    cfg = program.load_config(bench_tiny.BENCH, config)
    feed = traffic.BatchFeed(bench_tiny.TINY_BATCH, 11, CPU)
    flat = program.make_weights(cfg, 11, CPU, bench_tiny.REPO)
    model, kw = program.build_model(flat, cfg)
    dtype = torch.float32
    if program.bf16(cfg):
        model, dtype = model.to(torch.bfloat16), torch.bfloat16
    rows = torch.arange(feed.streams)
    state = pipeline.init_pipeline_state(feed.streams, model_dtype=dtype,
                                         device=CPU)
    pcms, gs = [], []
    for k in range(2):
        pcm, state, (g, _) = pipeline.enhance_chunk(
            model, feed.chunk(k), state, return_gr=True, device=CPU, **kw)
        pcms.append(pcm)
        gs.append(g)
    ref = R.enhance(feed.signal(rows, 2), R.unflatten(flat),
                    R.Precision.from_config(cfg), cfg["features"]["log1p"])
    pcm, g = torch.cat(pcms, 1), torch.cat(gs, 1)
    scale = float(ref["pcm"].abs().max())
    assert scale > 0.0
    # the same arithmetic; the GEMMs' blocking depends on the batch, so
    # f32 agrees to rounding and bf16 to a few of its own ulps
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert float((pcm - ref["pcm"]).abs().max()) <= tol * scale
    assert float((g - ref["g"]).abs().max()) <= (
        1e-5 if dtype == torch.float32 else 1e-2)


def test_the_control_rounds_one_step_below():
    p = R.Precision(dft="bfloat16", comb_store="bfloat16", model="bfloat16")
    assert p.lower() == R.Precision("float8", "float8", "float8", "tf32",
                                    "tf32")
    x = torch.tensor([1.0 + 2.0**-12, 1.0 + 2.0**-10, -3.0])
    assert torch.equal(R.round_tf32(x), torch.tensor([1.0, 1.0 + 2.0**-10,
                                                      -3.0]))
    y = torch.linspace(-2, 2, 101)
    assert float((R.round_fp8(y) - y).abs().max()) < 2 * 2.0 ** -3
    assert not torch.equal(R.round_fp8(y), y)
    assert np.isclose(float(R.round_fp8(y).abs().max()), 2.0)
