"""Nothing the benchmark runs imports JAX or the JAX package: the
top-level name of every loaded module (the part before the first dot) is
compared whole, so percepnet_tpu_torch passes and percepnet_tpu fails."""

import json
import subprocess
import sys

from benchmark import run as brun
from benchmark.tests import bench_tiny

PROBE = r"""
import json, pathlib, sys, time, tempfile, torch
sys.path.insert(0, {repo!r})
import benchmark.run as brun
from benchmark.tests import bench_tiny
bench, bench_dir = bench_tiny.make(pathlib.Path(tempfile.mkdtemp()))
for m in sorted((bench_dir / "metrics").glob("*.py")):
    brun.read_metric(m.stem, {{}}, bench_dir)
for cell in ("tiny-f32-batch", "tiny-bf16-stream"):
    bench_tiny.run(cell, bench, bench_dir, seconds=0.4)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_forbidden_names_are_whole_top_level_names(monkeypatch):
    mods = dict(sys.modules)
    mods.update({"percepnet_tpu_torch.ops": None, "jaxtyping": None})
    monkeypatch.setattr(sys, "modules", mods)
    assert "percepnet_tpu_torch.ops" not in brun.loaded_forbidden()
    assert "jaxtyping" not in brun.loaded_forbidden()
    mods["percepnet_tpu.ops"] = None
    mods["jax.numpy"] = None
    assert brun.loaded_forbidden() == ["jax.numpy", "percepnet_tpu.ops"]


def test_a_run_loads_no_jax_module():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=str(bench_tiny.REPO))],
        capture_output=True, text=True, timeout=600,
        cwd=str(bench_tiny.REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "percepnet_tpu_torch" in tops and "benchmark" in tops
    assert not tops & set(brun.FORBIDDEN)
