"""The port's shell recipes (percepnet_tpu_torch/recipes/*.sh) on the CPU,
with DEVICE=cpu, on a 4-pair x 2 s corpus made by tools/synth_dns.py
--seed 0 and laid out as <work>/pcm/{clean,noisy}.

  - dns_challenge.sh stages 2-5 (featgen -> split -> 2 training steps ->
    export): its nnet_data.cpp is byte for byte the JAX package's export
    of the same checkpoint (`python -m percepnet_tpu export`, in a
    subprocess), and its percepnet_weights.npz equals JAX's array by
    array (a zip's timestamps differ, so not the whole file);
  - quality_train.sh: stage 2 warm-starts from stage 1's last checkpoint
    (its checkpoint equals a `train --pretrain` run of the same steps, bit
    for bit), and each quality.json has the keys of the JAX tool's report;
  - multicard.sh: 2 gloo ranks under torchrun write one checkpoint, from
    rank 0;
  - quality_train_cpu.sh: its one command line;
  - no recipe invokes the JAX package.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(ROOT, "percepnet_tpu_torch", "recipes")
JAX_REPORT = os.path.join(ROOT, "artifacts",
                          "quality_exp_log1p_30000_fresh_holdout.json")
FRAMES = 100
STEPS = 2
TRAIN_ARGS = (f"--max-steps {STEPS} --batch-size 2 --seq-len 50 "
              "--no-tensorboard")
JAX_EXPORT = """import sys
from percepnet_tpu.cli.export import main
for name in ("nnet_data.cpp", "percepnet_weights.npz"):
    main([sys.argv[1], sys.argv[2] + "/" + name])
"""


def _env(**kw):
    """The recipes' environment: DEVICE=cpu unless kw says otherwise (a
    None value unsets the variable)."""
    env = dict(os.environ, DEVICE="cpu", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    env.update(kw)
    return {k: v for k, v in env.items() if v is not None}


def _bash(script, *args, timeout=300, **env):
    res = subprocess.run(
        ["bash", os.path.join(RECIPES, script), *map(str, args)], cwd=ROOT,
        env=_env(**env), capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout + res.stderr


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """dns_challenge.sh from stage 2; JAX's export of its checkpoint runs
    in the background while the tests that do not need it go first."""
    root = tmp_path_factory.mktemp("recipe")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "synth_dns.py"),
                    str(root / "src"), "--pairs", "4", "--seconds", "2",
                    "--seed", "0"], check=True, timeout=120,
                   capture_output=True)
    work = root / "work"
    for sub in ("clean", "noisy"):
        shutil.copytree(root / "src" / sub, work / "pcm" / sub)
    log = _bash("dns_challenge.sh", "clean", "noisy", work, 2,
                FRAMES_PER_UTT=str(FRAMES), TRAIN_ARGS=TRAIN_ARGS)
    jax_dir = root / "jax_export"
    jax_dir.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_EXPORT,
         str(work / "exp" / f"checkpoint-{STEPS}.npz"), str(jax_dir)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield {"work": work, "log": log, "jax": proc, "jax_dir": jax_dir}
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _jax_export(recipe):
    out, _ = recipe["jax"].communicate(timeout=300)
    assert recipe["jax"].returncode == 0, out[-3000:]
    return recipe["jax_dir"]


def test_dns_challenge_stages_2_to_5(recipe):
    work = recipe["work"]
    pairs = (work / "pairs.txt").read_text().splitlines()
    assert len(pairs) == 4
    assert all(ln.split()[2] == str(FRAMES) for ln in pairs)
    for ln in pairs:
        name = os.path.basename(ln.split()[0])
        feat = work / "feats" / name.replace(".pcm", ".f32")
        assert feat.stat().st_size == FRAMES * 138 * 4
    lists = {n: (work / "lists" / f"{n}_filelist.txt").read_text().split()
             for n in ("train", "dev")}
    assert (len(lists["train"]), len(lists["dev"])) == (3, 1)
    assert sorted(p.name for p in (work / "exp").glob("checkpoint-*")) == [
        f"checkpoint-{STEPS}.npz"]
    for stage in range(2, 6):
        assert f"== stage {stage}:" in recipe["log"]
    assert "== stage 1:" not in recipe["log"]


def test_quality_train_cpu_command_line(tmp_path):
    """The CPU recipe's one command, read through a stand-in `python` on
    PATH that records its arguments."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    argv_file = tmp_path / "argv.json"
    stub = bin_dir / "python"
    stub.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"json.dump(sys.argv[1:], open({str(argv_file)!r}, 'w'))\n")
    stub.chmod(0o755)
    _bash("quality_train_cpu.sh", "w", "", "7",
          PATH=f"{bin_dir}:{os.environ['PATH']}", DEVICE=None)
    assert json.loads(argv_file.read_text()) == [
        "-m", "percepnet_tpu_torch", "train",
        "--train-filelist", "w/lists/train_filelist.txt",
        "--config", "configs/dns_log1p_cpu.yaml",
        "--out-dir", "w/exp_log1p_cpu", "--pretrain",
        "w/exp8k/checkpoint-12000.npz", "--max-steps", "7",
        "--device-data-mb", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def quality(recipe, tmp_path_factory):
    """quality_train.sh on the recipe's lists, with clean/ and noisy/
    beside them as the recipe expects."""
    work = tmp_path_factory.mktemp("quality")
    src = recipe["work"]
    os.symlink(src / "lists", work / "lists")
    for sub in ("clean", "noisy"):
        os.symlink(src / "pcm" / sub, work / sub)
    log = _bash("quality_train.sh", work, TRAIN_ARGS=TRAIN_ARGS)
    return work, log


def test_quality_train_stage_2_warm_starts_from_stage_1(quality):
    work, _ = quality
    name = f"checkpoint-{STEPS}.npz"
    ref = work / "ref"
    res = subprocess.run(
        [sys.executable, "-m", "percepnet_tpu_torch", "train",
         "--train-filelist", str(work / "lists" / "train_filelist.txt"),
         "--dev-filelist", str(work / "lists" / "dev_filelist.txt"),
         "--config", "configs/dns_log1p_lin.yaml", "--out-dir", str(ref),
         "--device-data-mb", "9216", "--device", "cpu", "--pretrain",
         str(work / "exp_log1p" / name), *TRAIN_ARGS.split()],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(work / "exp_log1p_lin" / name) as got, \
            np.load(ref / name) as want, \
            np.load(work / "exp_log1p" / name) as stage1:
        assert sorted(got.files) == sorted(want.files)
        assert not [k for k in got.files
                    if not np.array_equal(got[k], want[k])]
        assert not np.array_equal(got["params/gru1/wh"],
                                  stage1["params/gru1/wh"])


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(tree[0])]
    return None


def test_quality_train_gates_write_the_jax_tools_json(quality):
    work, log = quality
    with open(JAX_REPORT) as f:
        want = _keys(json.load(f))
    for exp in ("exp_log1p", "exp_log1p_lin"):
        with open(work / exp / "quality.json") as f:
            report = json.loads(f.read())
        assert _keys(report) == want
        assert report["pairs"] == 1
        assert re.search(rf"== {exp}: quality_gate exited [01]\n", log)


def test_multicard_two_gloo_ranks(recipe, tmp_path):
    lists = recipe["work"] / "lists"
    log = _bash("multicard.sh", lists / "train_filelist.txt",
                lists / "dev_filelist.txt", tmp_path / "out",
                *TRAIN_ARGS.split(), NPROC="2",
                TORCHRUN_ARGS="--standalone --tee 3")
    assert "[default1]:" in log
    saved = [ln for ln in log.splitlines() if " saved " in ln]
    assert len(saved) == 1 and saved[0].startswith("[default0]:")
    assert sorted(p.name for p in (tmp_path / "out").glob(
        "checkpoint-*")) == [f"checkpoint-{STEPS}.npz"]


def test_recipe_runs_on_the_card_unless_told(recipe, tmp_path):
    """Without DEVICE, stage 5's export asks for the card: on a host
    without one the recipe fails rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    (tmp_path / "exp").mkdir()
    os.symlink(recipe["work"] / "exp" / f"checkpoint-{STEPS}.npz",
               tmp_path / "exp" / f"checkpoint-{STEPS}.npz")
    res = subprocess.run(
        ["bash", os.path.join(RECIPES, "dns_challenge.sh"), "clean", "noisy",
         str(tmp_path), "5"], cwd=ROOT, env=_env(DEVICE=None),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not (tmp_path / "exp" / "percepnet_weights.npz").exists()


def test_nnet_data_cpp_is_the_jax_export(recipe):
    jax_dir = _jax_export(recipe)
    got = (recipe["work"] / "exp" / "nnet_data.cpp").read_bytes()
    assert got == (jax_dir / "nnet_data.cpp").read_bytes()


def test_weights_npz_equals_the_jax_export(recipe):
    jax_dir = _jax_export(recipe)
    with np.load(recipe["work"] / "exp" / "percepnet_weights.npz") as got, \
            np.load(jax_dir / "percepnet_weights.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        assert len(got.files) == 30
        for k in got.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("script", ["dns_challenge.sh", "quality_train.sh",
                                    "quality_train_cpu.sh", "multicard.sh"])
def test_recipe_never_invokes_the_jax_package(script):
    text = open(os.path.join(RECIPES, script)).read()
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    assert not re.search(r"-m percepnet_tpu( |$)", code, re.M)
    assert "percepnet_tpu." not in code.replace("percepnet_tpu_torch", "")
    assert "jax" not in code
    assert re.search(r"^set -e?uo pipefail$", text, re.M)
    assert re.search(r"-m percepnet_tpu_torch\b", code)
