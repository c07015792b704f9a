"""Tiny cells of the benchmark's own configurations, for CPU tests: a
copy of the benchmark's data files in a temporary folder with small
mixes beside them, and BENCHMARK.json's entries extended by cells that
use them.  Each tiny cell is held to the limits of the real cell it
stands for."""

from __future__ import annotations

import copy
import json
import pathlib
import shutil

import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_BATCH = {"kind": "batch", "streams": 4, "frames_per_call": 20,
              "warmup_calls": 1, "sample_streams": 3,
              "pool": {"speech_clips": 2, "noise_clips": 2,
                       "clip_seconds": 0.5},
              "snr_db": [0.0, 18.0], "peak": 20000.0}
TINY_STREAM = {"kind": "stream", "slots": 4, "frame_period_ms": 10,
               "session_seconds": [0.1, 0.3], "sample_sessions": 4,
               "pool": {"speech_clips": 2, "noise_clips": 2,
                        "clip_seconds": 0.5},
               "snr_db": [0.0, 18.0], "peak": 20000.0}
# tiny cell -> (configuration, mix, the real cell whose limits it takes)
CELLS = {
    "tiny-f32-batch": ("percepnet-f32", "tiny-batch", "f32-batch"),
    "tiny-bf16-batch": ("percepnet-bf16-log1p", "tiny-batch", "bf16-batch"),
    "tiny-f32-stream": ("percepnet-f32", "tiny-stream", "f32-stream"),
    "tiny-bf16-stream": ("percepnet-bf16-log1p", "tiny-stream",
                         "bf16-stream"),
}


def load_benchmark() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def make(tmp: pathlib.Path) -> tuple[dict, pathlib.Path]:
    """(bench, bench_dir): a copy of benchmark/ under tmp with the tiny
    mixes and limits, and BENCHMARK.json's entries with the tiny cells."""
    bench_dir = tmp / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, mix in (("tiny-batch", TINY_BATCH),
                      ("tiny-stream", TINY_STREAM)):
        (bench_dir / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = copy.deepcopy(load_benchmark())
    for cell, (cfg, mix, real) in CELLS.items():
        shutil.copy(bench_dir / "limits" / f"{real}.json",
                    bench_dir / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "t"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    return bench, bench_dir


def run(cell: str, bench: dict, bench_dir: pathlib.Path, *, seed: int = 7,
        seconds: float = 0.3, control: bool = False) -> dict:
    import time
    from benchmark import run as brun
    return brun.run_cell(cell, seed, seconds, False,
                         device=torch.device("cpu"), bench=bench,
                         bench_dir=bench_dir, control=control,
                         t0=time.perf_counter())
