"""The control of `correct`: the reference computed one precision step
below the configuration (TF32 operands for float32, float8 for bfloat16),
put in the program's place and compared by the same judge, has to come
out as not correct under each cell's limits.  On the CPU at a tiny size;
the card test runs it at the cells' own sizes."""

import pathlib
import time

import pytest
import torch

from benchmark.harness import judge
from benchmark.tests import bench_tiny


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_tiny.make(pathlib.Path(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", sorted(bench_tiny.CELLS))
def test_the_control_is_not_correct(tiny, cell):
    bench, bench_dir = tiny
    out = bench_tiny.run(cell, bench, bench_dir, seed=9, seconds=0.5,
                         control=True)
    assert out["correct"] is True, out["compared"]
    spec = judge.load_limits(bench_dir, cell)
    ok, compared = judge.verdict(out["numbers"]["control"], spec, 0)
    assert not ok, compared


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["bf16-stream", "f32-batch", "bf16-batch",
                                  "f32-stream"])
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import run as brun
    out = brun.run_cell(cell, 2**31 + 101, 4.0, False,
                        device=torch.device("cuda", 0), control=True,
                        t0=time.perf_counter())
    assert out["correct"] is True, out["compared"]
    ok, compared = judge.verdict(out["numbers"]["control"],
                                 judge.load_limits(bench_tiny.BENCH, cell), 0)
    assert not ok, compared
