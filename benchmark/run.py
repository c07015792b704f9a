"""Run one cell of the benchmark of percepnet_tpu_torch once.

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name: BENCHMARK.json names the cell,
benchmark/configs/<config>.json the configuration,
benchmark/traffic/<traffic>.json the mix, benchmark/loops/<kind>.py the
loop that the mix's "kind" names, benchmark/metrics/<metric>.py each
per-layer metric's reader, benchmark/limits/<cell>.json the limits of
`correct`.

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, with --trace 1 a
breakdown, and last `compared`, each number of the correctness check
beside its limit; the same numbers close standard error.  Exits 2
without a CUDA card (or with fewer than the cell asks for), and 3 if a
JAX module is loaded once the window has closed; neither prints a
result.

--sweep S1,S2,...  (not a run of a cell): a stream cell's load sweep, one
window per slot count on the 10 ms frame clock, in one process, one line
each.
--control: also compare the reference computed one precision step below
the configuration (the control of `correct`); the benchmark's own runs
do not pass it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse                                                  # noqa: E402
import importlib.util                                            # noqa: E402
import json                                                      # noqa: E402
import os                                                        # noqa: E402
import pathlib                                                   # noqa: E402
import subprocess                                                # noqa: E402
import sys                                                       # noqa: E402
from dataclasses import dataclass                                # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "percepnet_tpu")

# every cache of the run inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(REPO / "build" / "benchmark_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")

import torch                                                     # noqa: E402

from benchmark.harness import judge, program, traffic            # noqa: E402
from benchmark.harness import trace as tr                        # noqa: E402


@dataclass
class Context:
    cell: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    repo: pathlib.Path
    t0: float
    control: bool = False
    slots: int | None = None

    def profile(self, fn, calls: int) -> dict:
        """The profiler window over fn (`calls` calls or ticks), with
        the launches the program counted for each comb kernel entry."""
        from percepnet_tpu_torch.ops import comb
        return tr.summary(fn, self.device, calls,
                          lambda: dict(comb.launches))


def load_benchmark(root: pathlib.Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or its per-layer ones when traced."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, layer: dict, bench_dir: pathlib.Path = BENCH):
    """benchmark/metrics/<name>.py's read(layer): a number, or None."""
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "benchmark_metric_").read(layer)


def load_module(path: pathlib.Path, prefix: str):
    """The Python file at `path`, loaded under a name of its own."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(kind: str, bench_dir: pathlib.Path = BENCH):
    """benchmark/loops/<kind>.py, whose run(ctx) drives a mix of that
    kind."""
    path = bench_dir / "loops" / f"{kind}.py"
    if "/" in kind or not path.is_file():
        raise SystemExit(f"no loop for the mix kind {kind!r} ({path})")
    return load_module(path, "benchmark_loop_")


def loaded_forbidden() -> list[str]:
    """Modules in sys.modules whose top-level name is a JAX package's or
    the JAX package of this repository."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card(device: torch.device) -> dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "count": 1}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: torch.device, bench: dict | None = None,
             bench_dir: pathlib.Path = BENCH, repo: pathlib.Path = REPO,
             control: bool = False, slots: int | None = None,
             t0: float = T0) -> dict:
    """One run of one cell on `device`; returns the result line's
    object, with "numbers" (the check's readings) and "layer" (what the
    per-layer readers read) beside it."""
    bench = bench or load_benchmark(repo)
    cell = find_cell(bench, name)
    cfg = program.load_config(bench_dir, cell["config"])
    mix = traffic.load_mix(bench_dir, cell["traffic"])
    ctx = Context(name, cfg, mix, seed, seconds, trace, device, repo, t0,
                  control, slots)
    res = load_loop(mix["kind"], bench_dir).run(ctx)
    spec = judge.load_limits(bench_dir, name)
    correct, compared = judge.verdict(res["numbers"], spec, res["failed"])
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = res["end_to_end"].get(m["name"]) if not trace else \
            read_metric(m["name"], res["layer"], bench_dir)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = res["memory_peak_bytes"]
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        t = res["layer"]["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["wall_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["compared"] = compared
    out["numbers"] = res["numbers"]
    out["layer"] = res["layer"]
    return out


def sweep(name: str, seed: int, seconds: float, counts: list[int],
          device: torch.device) -> None:
    """One window per slot count on the frame clock; prints one JSON
    line each."""
    bench = load_benchmark()
    cell = find_cell(bench, name)
    cfg = program.load_config(BENCH, cell["config"])
    mix = traffic.load_mix(BENCH, cell["traffic"])
    import numpy as np
    stream = load_loop(mix["kind"])
    for s in counts:
        ctx = Context(name, cfg, mix, seed, seconds, False, device, REPO,
                      time.perf_counter(), slots=s)
        res = stream.run(ctx, paced=True)
        lat = np.asarray(res["layer"]["latency_ms"])
        late = np.asarray(res["layer"]["lateness_ms"])
        tail = late[len(late) * 9 // 10:]
        print(json.dumps({
            "slots": s, "ticks": len(lat),
            "latency_p50_ms": float(np.median(lat)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "latency_max_ms": float(lat.max()),
            "late_last_tenth_median_ms": float(np.median(tail)),
            "backlog_growing": bool(np.median(tail)
                                    > mix["frame_period_ms"]),
            "failed": res["failed"], "numbers": res["numbers"]}),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    bench = load_benchmark()
    chips = find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {power_limit()}", file=sys.stderr)
    if args.sweep:
        sweep(args.workload, args.seed, args.seconds,
              [int(s) for s in args.sweep.split(",")], device)
        return 0
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device=device, bench=bench, control=args.control)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: JAX modules are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    numbers = out.pop("numbers")
    del out["layer"]
    print(f"check: {json.dumps(numbers)}", file=sys.stderr)
    for key, c in out["compared"].items():
        print(f"compared {key}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
