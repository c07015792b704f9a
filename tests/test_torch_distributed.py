"""Data-parallel training across processes on the CPU: two real
`python -m percepnet_tpu_torch train --distributed --device cpu` ranks
in a gloo group, against the same global batch stream trained in one
process, by the port and by the JAX package.

Each rank reads its shard of 4 record files through the native loader
(NativeBatchLoader(shard_id=rank, num_shards=2)), 2 x 8 per rank for 3
steps; the global batch is the two ranks' batches in rank order.  Bounds:
the port's one process within tests/test_distributed.py's rtol 2e-5 /
atol 2e-6 (every checkpoint array) and 1e-5 (losses); JAX's Trainer on
its 8-device mesh within the port's training bound of 1e-5
(tests/test_torch_train_cli.py: losses relative, params absolute).  All
three start from JAX's initial parameters (--pretrain).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from percepnet_tpu.io import native as j_native
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.parallel import mesh as j_pm
from percepnet_tpu.train import checkpoint as j_ckpt
from percepnet_tpu.train.trainer import TrainConfig as JTrainConfig
from percepnet_tpu.train.trainer import Trainer as JTrainer
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.io import native
from percepnet_tpu_torch.train.trainer import Trainer, TrainConfig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN, PER_RANK, STEPS, SEED, WORLD = 8, 2, 3, 0, 2
RTOL, ATOL, LOSS_ABS = 2e-5, 2e-6, 1e-5       # tests/test_distributed.py
JAX_LOSS_REL, JAX_PARAM_ABS = 1e-5, 1e-5       # the port's training bound


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _history(out_dir):
    with open(os.path.join(out_dir, "history.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _losses(out_dir):
    return {r["step"]: r["loss"] for r in _history(out_dir) if "loss" in r}


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _combined(files):
    """The global stream: rank 0's batch, then rank 1's, per step."""
    loaders = [native.NativeBatchLoader(files, SEQ_LEN, PER_RANK,
                                        shard_id=r, num_shards=WORLD,
                                        seed=SEED) for r in range(WORLD)]
    while True:
        yield np.concatenate([next(ld) for ld in loaders])


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """The 2-rank CLI run: (tmp dir, record files, each rank's output)."""
    if not (native.available() and j_native.available()):
        pytest.skip("native loader unavailable; the CLI would use the "
                    "Python loader")
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(42)
    files = []
    for i in range(4):
        path = tmp / f"rec{i}.f32"
        rng.uniform(0.0, 0.9, (SEQ_LEN, C.RECORD_DIM)).astype(
            np.float32).tofile(path)
        files.append(str(path))
    (tmp / "train.lst").write_text("\n".join(files) + "\n")
    j_ckpt.save_params_npz(str(tmp / "init.npz"), jax.device_get(
        j_model.init_params(jax.random.PRNGKey(SEED))))
    argv = [sys.executable, "-m", "percepnet_tpu_torch", "train",
            "--train-filelist", str(tmp / "train.lst"),
            "--out-dir", str(tmp / "dp"), "--batch-size", str(PER_RANK),
            "--seq-len", str(SEQ_LEN), "--max-steps", str(STEPS),
            "--log-interval", "1", "--no-tensorboard", "--device", "cpu",
            "--pretrain", str(tmp / "init.npz"), "--distributed",
            "--coordinator", f"localhost:{_free_port()}",
            "--num-processes", str(WORLD)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv + ["--process-id", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return tmp, files, outs


def test_two_ranks_write_once_from_rank_0(two_rank_run):
    tmp, _, outs = two_rank_run
    written = sorted(os.listdir(tmp / "dp"))
    assert written == ["checkpoint-3.npz", "config.yml", "history.jsonl"]
    hist = _history(tmp / "dp")
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert "saved" in outs[0] and "saved" not in outs[1]
    assert "using native C++ batch loader" in outs[1]
    assert "device-resident" not in outs[0] + outs[1]
    # audio-s/s counts the global batch
    rec = hist[-1]
    want = rec["steps_per_s"] * PER_RANK * WORLD * SEQ_LEN * 480 / 48_000
    assert abs(rec["train_audio_s_per_s"] - want) <= 0.1 + 1e-3 * want


def test_two_ranks_match_one_process_on_the_global_stream(two_rank_run):
    """The port's Trainer in one process, 4 x 8 per step from the two
    shards' batches in rank order: every checkpoint array and loss."""
    tmp, files, _ = two_rank_run
    cfg = TrainConfig(batch_size=WORLD * PER_RANK, seq_len=SEQ_LEN,
                      train_max_steps=STEPS, log_interval_steps=1,
                      seed=SEED, out_dir=str(tmp / "one"))
    tr = Trainer(cfg, _combined(files), device="cpu", tensorboard=False)
    tr.load_pretrained(str(tmp / "init.npz"))
    tr.run()
    got = _flat(tmp / "dp" / f"checkpoint-{STEPS}.npz")
    ref = _flat(tmp / "one" / f"checkpoint-{STEPS}.npz")
    assert set(got) == set(ref) and int(got["step"]) == STEPS
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    losses, want = _losses(tmp / "dp"), _losses(tmp / "one")
    assert losses.keys() == want.keys() and len(losses) == STEPS
    for s in losses:
        assert abs(losses[s] - want[s]) < LOSS_ABS, (s, losses, want)


def test_two_ranks_match_jax_trainer_on_its_mesh(two_rank_run):
    """JAX's Trainer over 4 of its 8 virtual devices on the same global
    stream, from the same parameters."""
    tmp, files, _ = two_rank_run
    cfg = JTrainConfig(batch_size=WORLD * PER_RANK, seq_len=SEQ_LEN,
                       train_max_steps=STEPS, save_interval_steps=STEPS,
                       eval_interval_steps=10**9, log_interval_steps=1,
                       seed=SEED, out_dir=str(tmp / "jax"))
    tr = JTrainer(cfg, _combined(files), mesh=j_pm.make_mesh(
        jax.devices()[:4]), tensorboard=False)
    tr.run()
    got = _flat(tmp / "dp" / f"checkpoint-{STEPS}.npz")
    ref = _flat(tmp / "jax" / f"checkpoint-{STEPS}.npz")
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        if np.issubdtype(ref[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=JAX_PARAM_ABS, err_msg=k)
        else:                       # step and optax's counters
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    losses, want = _losses(tmp / "dp"), _losses(tmp / "jax")
    assert losses.keys() == want.keys()
    for s in losses:
        assert abs(losses[s] - want[s]) <= JAX_LOSS_REL * want[s]
