"""The port's measurement and quality tools (percepnet_tpu_torch.tools) on
the CPU, against the JAX package's tools where both answer one question.

Bounds (measured on these inputs, from a CPU run, in brackets):
  - flop_bound: the model's FLOPs within 1% of 2 x parameters x B x T
    (the JAX tool's check) [0.4%]; spectra's FLOPs within 2% of the JAX
    tool's XLA count at the same shape, which adds elementwise work the
    port's counter leaves out [0.1%]; the counted stages exactly linear in
    B; each bound the larger of its two times; the serving tier's speed of
    light above the f32 tier's.
  - quality_gate on a 2-pair x 2 s holdout made by tools/synth_dns.py
    (run as a subprocess), against the two calls the JAX tool makes
    (percepnet_tpu.cli.enhance.enhance_files, cli.evaluate.evaluate_pair):
    noisy baselines within 1e-4 [0], f32 STOI within 1e-3 and SI-SDR
    within 0.01 dB [0, 0], and the JSON keys of the JAX tool's report
    (artifacts/quality_exp_log1p_30000_fresh_holdout.json was written by
    it).  JAX's enhance_files runs in 16-frame chunks, the shape
    tests/test_torch_cli.py already compiles, with JAX's persistent
    compilation cache off (a stale entry can reload a graph as zeros, the
    XLA:CPU cache flake of tests/test_serve.py); an all-zero JAX output
    fails the test.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from percepnet_tpu.cli import enhance as j_enhance
from percepnet_tpu.cli import evaluate as j_evaluate
from percepnet_tpu_torch.models.percepnet import LAYERS
from percepnet_tpu_torch.tools import (check_all, check_parity, flop_bound,
                                       profile_pipeline, quality_gate,
                                       scaling_bench)
from percepnet_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "artifacts", "exp_log1p_30000_params.npz")
JAX_REPORT = os.path.join(ROOT, "artifacts",
                          "quality_exp_log1p_30000_fresh_holdout.json")
CPU = torch.device("cpu")
N_PARAMS = sum(math.prod(s) for leaves in LAYERS.values()
               for s in leaves.values())


def _run(main, argv):
    """(return value, stdout) of a tool's main(argv) in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


# --- utils.profiling ------------------------------------------------------
def test_stage_time_on_cpu_measures_wall_only():
    x = torch.ones(64, 64)
    res = profiling.stage_time(torch.matmul, x, x, iters=2, device=CPU)
    assert res["wall_ms"] > 0 and res["untraced_wall_ms"] == res["wall_ms"]
    assert res["device_ms"] is res["launches"] is res["busy_share"] is None
    assert res["margin_s"] is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "tb" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_throughput_meter_counts_units():
    meter = profiling.ThroughputMeter()
    meter.add(3.0)
    meter.add(2.0)
    assert meter.elapsed() > 0 and meter.rate() > 0
    meter.reset()
    assert meter.rate() == 0.0


def test_peaks_are_the_h100s():
    assert profiling.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert profiling.bound_ms(0, 67e9) == (1.0, "operations")
    assert flop_bound.PEAKS == {"f32": 67e12, "bf16": 989e12}


# --- profile_pipeline + flop_bound ----------------------------------------
@pytest.fixture(scope="module")
def profile_out():
    _, out = _run(profile_pipeline.main, [
        "--device", "cpu", "--batch", "2", "--frames", "8", "--iters", "1",
        "--json"])
    return out


def test_profile_pipeline_prints_every_stage(profile_out):
    lines = profile_out.strip().splitlines()
    names = [m.group(1) for m in (re.match(r"^(.{12}) +[0-9.]+ ms$", ln)
                                  for ln in lines) if m]
    assert [n.strip() for n in names] == list(profile_pipeline.STAGES)
    for sub in profile_pipeline.PITCH_SUB_STAGES:
        assert f"  {sub:10s}" in names
    data = json.loads(lines[-1])
    assert {"batch", "frames", "iters", "tier", "pitch_tier", "device",
            "card", "stages"} <= set(data)
    assert data["card"] is None and data["pitch_tier"] == "f32"
    for row in data["stages"]:
        assert {"name", "parent", "wall_ms", "device_ms", "launches",
                "busy_share", "untraced_wall_ms", "margin_s",
                "b1_launches"} <= set(row)
        assert row["wall_ms"] > 0
        # the host never reports a device number; B1 is the card's
        assert row["device_ms"] is None and row["b1_launches"] == 0


def test_flop_bound_merges_the_profile(profile_out, tmp_path):
    log = tmp_path / "profile.log"
    log.write_text(profile_out)
    _, out = _run(flop_bound.main, ["--device", "cpu", "--batch", "2",
                                    "--frames", "8", "--profile-log",
                                    str(log), "--json"])
    data = _last_json(out)
    rows = {r["name"]: r for r in data["stages"]}
    prof = {r["name"]: r for r in _last_json(profile_out)["stages"]}
    for name in ("spectra", "xcorr", "wenergy", "comb", "selscan"):
        assert rows[name]["measured"] == prof[name]["wall_ms"] / 1e3
        assert rows[name]["eff"] == rows[name]["bound"] / rows[name][
            "measured"]
    assert rows["model"]["measured"] == prof["model f32"]["wall_ms"] / 1e3
    # text lines alone give the wall times, to the printed 0.1 ms
    text = tmp_path / "text.log"
    text.write_text("\n".join(profile_out.splitlines()[:-1]) + "\n")
    xcorr = flop_bound.read_profile(str(text))["xcorr"]
    assert xcorr["device_s"] is None
    assert abs(xcorr["wall_s"] - prof["xcorr"]["wall_ms"] / 1e3) <= 5e-5


@pytest.fixture(scope="module")
def bounds():
    res = {}
    for tier, extra in (("f32", []), ("serving", ["--serving"])):
        _, out = _run(flop_bound.main, ["--device", "cpu", "--batch", "4",
                                        "--frames", "16", "--json", *extra])
        res[tier] = _last_json(out)
    return res


def test_flop_bound_model_flops_are_twice_the_parameters(bounds):
    rows = {r["name"]: r for r in bounds["f32"]["stages"]}
    want = 2 * N_PARAMS * 4 * 16
    assert abs(rows["model"]["flops"] - want) / want < 0.01
    assert rows["model"]["how"] == "analytic"


def test_flop_bound_spectra_flops_match_the_jax_tool(bounds, capsys):
    sys.path.insert(0, ROOT)
    from tools import flop_bound as j_flop_bound
    j_flop_bound.main(["--batch", "4", "--frames", "16", "--json"])
    j_rows = {r["name"]: r for r in _last_json(
        capsys.readouterr().out)["stages"]}
    rows = {r["name"]: r for r in bounds["f32"]["stages"]}
    assert abs(rows["spectra"]["flops"] - j_rows["spectra"]["flops"]) \
        / j_rows["spectra"]["flops"] < 0.02
    assert rows["spectra"]["bytes"] == j_rows["spectra"]["bytes"]


def test_flop_bound_counts_are_linear_in_batch():
    one = flop_bound.counted_stages(1, 16, serving=False)
    three = flop_bound.counted_stages(3, 16, serving=False)
    assert [r["name"] for r in one] == [r["name"] for r in three]
    for a, b in zip(one, three):
        assert b["flops"] == 3 * a["flops"], a["name"]
        assert b["bytes"] == 3 * a["bytes"], a["name"]
    assert {r["name"] for r in one if r["flops"] > 0} >= {
        "spectra", "xcorr", "decide", "comb"}


@pytest.mark.parametrize("tier", ["f32", "serving"])
def test_flop_bound_every_bound_is_the_larger_time(bounds, tier):
    data = bounds[tier]
    total = 0.0
    for row in data["stages"]:
        assert row["bound"] == max(row["t_flop"], row["t_mem"])
        assert row["t_flop"] == row["flops"] / row["peak_flops_per_s"]
        assert row["bytes"] > 0 and row["flops"] >= 0
        total += row["bound"] if row["in_total"] else 0.0
    assert data["total_bound_s"] == pytest.approx(total, rel=1e-12)
    peaks = {r["name"]: r["peak"] for r in data["stages"]}
    assert peaks["model"] == ("bf16" if tier == "serving" else "f32")
    assert {p for n, p in peaks.items() if not n.startswith("model")} == {
        "f32"}


def test_flop_bound_serving_tier_has_a_higher_speed_of_light(bounds):
    assert (bounds["serving"]["speed_of_light_audio_s_per_s"]
            > bounds["f32"]["speed_of_light_audio_s_per_s"])


# --- quality_gate ---------------------------------------------------------
@pytest.fixture(scope="module")
def holdout(tmp_path_factory):
    d = tmp_path_factory.mktemp("holdout")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "synth_dns.py"), str(d),
                    "--pairs", "2", "--seconds", "2", "--seed", "999",
                    "--start-index", "90000"], check=True, timeout=300)
    return str(d / "clean"), str(d / "noisy")


@pytest.fixture(scope="module")
def port_report(holdout, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("port_gate"))
    rc, out = _run(quality_gate.main, [
        "--weights", CHECKPOINT, "--clean-dir", holdout[0], "--noisy-dir",
        holdout[1], "--log1p", "--limit", "2", "--out-dir", out_dir,
        "--device", "cpu"])
    report = _last_json(out)
    assert rc == (0 if report["enhancement_ok"]
                  and report["bf16_gate_ok"] else 1)
    return report


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(tree[0])]
    return None


def test_quality_gate_json_has_the_jax_tools_keys(port_report):
    with open(JAX_REPORT) as f:
        assert _keys(port_report) == _keys(json.load(f))


def test_quality_gate_matches_jax_enhance_and_evaluate(holdout, port_report,
                                                       tmp_path):
    clean_dir, noisy_dir = holdout
    names = [r["name"] for r in port_report["per_pair"]]
    assert sorted(names) == sorted(n[:-4] for n in os.listdir(noisy_dir))
    cleans = [os.path.join(clean_dir, n + ".pcm") for n in names]
    noisys = [os.path.join(noisy_dir, n + ".pcm") for n in names]

    base = [j_evaluate.evaluate_pair(c, n, align=False)
            for c, n in zip(cleans, noisys)]
    for k in ("stoi", "si_sdr_db"):
        assert abs(port_report["noisy_baseline"][k]
                   - np.mean([r[k] for r in base])) <= 1e-4
    for row, b in zip(port_report["per_pair"], base):
        assert abs(row["noisy_si_sdr_db"] - b["si_sdr_db"]) <= 1e-4
        assert abs(row["noisy_stoi"] - b["stoi"]) <= 1e-4

    outs = [str(tmp_path / (n + ".pcm")) for n in names]
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        j_enhance.enhance_files(j_enhance.load_params(CHECKPOINT), noisys,
                                outs, raw_scale=True, log1p_features=True,
                                batch_frames=16)
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
    assert all(np.fromfile(o, "<i2").any() for o in outs)
    rows = [j_evaluate.evaluate_pair(c, o) for c, o in zip(cleans, outs)]
    assert abs(port_report["f32"]["stoi"]
               - np.mean([r["stoi"] for r in rows])) <= 1e-3
    assert abs(port_report["f32"]["si_sdr_db"]
               - np.mean([r["si_sdr_db"] for r in rows])) <= 0.01


# --- scaling_bench, check_parity, check_all -------------------------------
def test_scaling_bench_gloo_worlds_one_and_two():
    results, out = _run(scaling_bench.main, [
        "--device", "cpu", "--backend", "gloo", "--max-world", "2",
        "--per-device-batch", "2", "--seq-len", "10", "--steps", "2"])
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert lines == results
    assert [r["devices"] for r in results] == [1, 2]
    assert [r["batch"] for r in results] == [2, 4]
    for r in results:
        assert r["audio_s_per_s"] > 0 and r["step_ms"] > 0
        assert r["backend"] == "gloo" and r["device"] == "cpu"
    assert "efficiency_vs_1dev" not in results[0]
    assert results[1]["efficiency_vs_1dev"] == pytest.approx(
        results[1]["audio_s_per_s"] / (2 * results[0]["audio_s_per_s"]))


def test_check_parity_passes_on_the_cpu():
    rc, out = _run(check_parity.main, ["--device", "cpu"])
    assert rc == 0, out
    assert "PARITY OK" in out


def test_check_all_lists_what_is_not_the_ports(capfd):
    rc = check_all.main(["--skip", "quality", "--device", "cpu"])
    data = _last_json(capfd.readouterr().out)
    assert rc == 0 and data["ok"]
    assert [s["stage"] for s in data["stages"]] == ["parity"]
    assert data["stages"][0]["ok"]
    skipped = {s["stage"]: s for s in data["skipped"]}
    assert set(skipped) == {"quality", "roundtrip", "card"}
    assert "test_torch_io" in skipped["roundtrip"]["reason"]
    assert "chip_smoke.py" in skipped["card"]["reason"]
    assert all(s["requested"] for s in skipped.values())


def test_check_all_without_data_is_red(capfd, tmp_path):
    rc = check_all.main(["--skip", "parity", "--device", "cpu",
                         "--weights", CHECKPOINT,
                         "--noisy-dir", str(tmp_path / "missing")])
    data = _last_json(capfd.readouterr().out)
    assert rc == 1 and not data["ok"]
    assert {"stage": "quality", "reason": "no weights/noisy-dir",
            "requested": False} in data["skipped"]


TOOL_ARGS = {
    "profile_pipeline": (profile_pipeline.main, []),
    "flop_bound": (flop_bound.main, []),
    "quality_gate": (quality_gate.main, ["--weights", CHECKPOINT,
                                         "--clean-dir", "c", "--noisy-dir",
                                         "n"]),
    "scaling_bench": (scaling_bench.main, []),
    "check_parity": (check_parity.main, []),
    "check_all": (check_all.main, []),
}


@pytest.mark.parametrize("tool", sorted(TOOL_ARGS))
def test_tool_without_a_card_exits_and_names_it(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    main, argv = TOOL_ARGS[tool]
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "no CUDA card" in err and "--device cpu" in err
