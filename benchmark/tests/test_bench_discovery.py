"""The harness finds configurations, mixes, metrics and limits by name:
in a copy of the folder, one new configuration file, one new mix file,
one new metric file (and the new cell's limits) with three new JSON
entries make a cell that runs, and no file that was there changes."""

import hashlib
import json
import pathlib
import shutil

from benchmark import run as brun
from benchmark.tests import bench_tiny


def _digests(root: pathlib.Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_added_as_files_runs(tmp_path):
    bench, bench_dir = bench_tiny.make(tmp_path)
    before = _digests(bench_dir)

    cfg = json.loads((bench_dir / "configs" / "percepnet-f32.json")
                     .read_text())
    cfg["name"] = "percepnet-f32-copy"
    (bench_dir / "configs" / "percepnet-f32-copy.json").write_text(
        json.dumps(cfg))
    mix = dict(bench_tiny.TINY_BATCH, streams=2, frames_per_call=10)
    (bench_dir / "traffic" / "tiny-2x10.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "calls_seen.batch.py").write_text(
        "def read(layer):\n    return layer.get('calls')\n")
    shutil.copy(bench_dir / "limits" / "f32-batch.json",
                bench_dir / "limits" / "new-cell.json")
    bench["configs"].append({"name": "percepnet-f32-copy",
                             "source": "https://arxiv.org/abs/2008.04259",
                             "file": "benchmark/configs/"
                                     "percepnet-f32-copy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell",
                               "config": "percepnet-f32-copy",
                               "traffic": "tiny-2x10", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "calls_seen.batch", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "pipeline",
                               "moves": "audio_s_per_s",
                               "workloads": ["new-cell"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "audio_s_per_s")["workloads"].append("new-cell")

    out = bench_tiny.run("new-cell", bench, bench_dir, seconds=0.2)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] % 2 == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert [m["name"] for m in brun.metrics_of(bench, "new-cell", True)] \
        == ["calls_seen.batch"]
    assert brun.read_metric("calls_seen.batch", out["layer"],
                            bench_dir) == out["attempted"] // 2
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


def test_every_named_file_exists():
    bench = bench_tiny.load_benchmark()
    for c in bench["configs"]:
        assert (bench_tiny.REPO / c["file"]).is_file()
        assert json.loads((bench_tiny.REPO / c["file"]).read_text())[
            "name"] == c["name"]
    for w in bench["workloads"]:
        mix = bench_tiny.BENCH / "traffic" / f"{w['traffic']}.json"
        kind = json.loads(mix.read_text())["kind"]
        assert (bench_tiny.BENCH / "loops" / f"{kind}.py").is_file()
        assert (bench_tiny.BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (bench_tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert brun.read_metric(m["name"], {}) is None


def test_a_mix_of_a_new_kind_finds_its_loop_by_name(tmp_path):
    """A mix's "kind" names benchmark/loops/<kind>.py: a new loop file
    and a mix of that kind make a cell, and no file that was there
    changes."""
    bench, bench_dir = bench_tiny.make(tmp_path)
    before = _digests(bench_dir)
    (bench_dir / "loops" / "batch_twice.py").write_text(
        "import pathlib\n"
        "from benchmark import run as brun\n\n\n"
        "def run(ctx):\n"
        "    here = pathlib.Path(__file__).resolve().parents[1]\n"
        "    res = brun.load_loop('batch', here).run(ctx)\n"
        "    res['layer']['loop'] = 'batch_twice'\n"
        "    return res\n")
    mix = dict(bench_tiny.TINY_BATCH, kind="batch_twice")
    (bench_dir / "traffic" / "tiny-twice.json").write_text(json.dumps(mix))
    shutil.copy(bench_dir / "limits" / "f32-batch.json",
                bench_dir / "limits" / "twice-cell.json")
    bench["workloads"].append({"name": "twice-cell",
                               "config": "percepnet-f32",
                               "traffic": "tiny-twice", "chips": 1,
                               "why": "test"})
    out = bench_tiny.run("twice-cell", bench, bench_dir, seconds=0.2)
    assert out["correct"] is True, out["compared"]
    assert out["layer"]["loop"] == "batch_twice"
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before


def test_a_mix_whose_loop_is_missing_is_refused(tmp_path):
    import pytest
    bench, bench_dir = bench_tiny.make(tmp_path)
    mix = dict(bench_tiny.TINY_BATCH, kind="no_such_loop")
    (bench_dir / "traffic" / "tiny-none.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "none-cell",
                               "config": "percepnet-f32",
                               "traffic": "tiny-none", "chips": 1,
                               "why": "test"})
    with pytest.raises(SystemExit, match="no loop"):
        bench_tiny.run("none-cell", bench, bench_dir, seconds=0.2)
