"""The port's Trainer and its commands (train, split-dataset, bin2h5) on the
CPU against the JAX package's: Trainer.run and `train` from the same
initial params (JAX's, carried across) give JAX's history losses and
final params within the Adam bound of tests/test_torch_train.py (losses
1e-5 relative, params 1e-5 absolute); `split-dataset` and `bin2h5` write
JAX's files; configs load as JAX's TrainConfig loads them; a SIGTERM'd
run and a resumed one continue exactly where they stopped."""

import dataclasses
import glob
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from percepnet_tpu.cli import data as j_data
from percepnet_tpu.cli import train as j_train
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.train import checkpoint as j_ckpt
from percepnet_tpu.train import datasets as j_datasets
from percepnet_tpu.train.trainer import TrainConfig as JTrainConfig
from percepnet_tpu.train.trainer import Trainer as JTrainer
from percepnet_tpu_torch import __main__ as dispatcher
from percepnet_tpu_torch.cli import train as cli_train
from percepnet_tpu_torch.parallel import make_mesh
from percepnet_tpu_torch.parallel import mesh as pm
from percepnet_tpu_torch.train import checkpoint as ckpt
from percepnet_tpu_torch.train import datasets
from percepnet_tpu_torch.train.trainer import Trainer, TrainConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
STEP_LOSS_REL = 1e-5
PARAM_ABS = 1e-5
KW = dict(batch_size=2, seq_len=5, train_max_steps=4, log_interval_steps=1,
          eval_interval_steps=1, save_interval_steps=1)


def _history(out_dir):
    with open(os.path.join(out_dir, "history.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_runs_match(j_dir, p_dir, step):
    jh, ph = _history(j_dir), _history(p_dir)
    assert [sorted(r) for r in jh] == [sorted(r) for r in ph]
    for a, b in zip(jh, ph):
        for key in ("loss", "eval_loss"):
            if key in a:
                assert abs(a[key] - b[key]) <= STEP_LOSS_REL * a[key], \
                    (a, b)
    want = _flat(os.path.join(j_dir, f"checkpoint-{step}.npz"))
    got = _flat(os.path.join(p_dir, f"checkpoint-{step}.npz"))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ABS,
                                   err_msg=k)


class _Records:
    def __init__(self, recs):
        self.recs = recs

    def __len__(self):
        return len(self.recs)

    def __getitem__(self, i):
        return self.recs[i]


@pytest.mark.parametrize("mode", ["loader", "device_data"])
def test_trainer_run_matches_jax(tmp_path, mode):
    """4 steps at 2 x 5 with every interval 1, from JAX's initial params:
    history.jsonl (losses, eval losses) and every checkpoint's arrays as
    JAX's, with the host-batch loader and with the corpus on the device."""
    recs = np.random.default_rng(11).uniform(
        0.05, 0.95, (6, 5, 138)).astype(np.float32)
    ds = _Records(recs)
    dev = recs[:2]
    runs = {}
    for tag, (T, C, D) in {"jax": (JTrainer, JTrainConfig, j_datasets),
                           "port": (Trainer, TrainConfig, datasets)}.items():
        cfg = C(out_dir=str(tmp_path / tag), **KW)
        kw = {} if tag == "jax" else {"device": "cpu"}
        if mode == "loader":
            tr = T(cfg, D.batch_iterator(ds, 2, seed=3), [dev],
                   tensorboard=False, **kw)
        else:
            tr = T(cfg, D.index_iterator(len(ds), 2, seed=3),
                   [np.arange(2, dtype=np.int32)], tensorboard=False,
                   device_data=D.load_all_chunks(ds),
                   device_dev=D.load_all_chunks(ds)[:2], **kw)
        runs[tag] = tr
    j_ckpt.save_params_npz(str(tmp_path / "init.npz"),
                           jax.device_get(runs["jax"].state.params))
    runs["port"].load_pretrained(str(tmp_path / "init.npz"))
    for tr in runs.values():
        tr.run()
    _assert_runs_match(str(tmp_path / "jax"), str(tmp_path / "port"), 4)
    hist = _history(str(tmp_path / "port"))
    assert sum("eval_loss" in r for r in hist) == 4
    for r in hist:
        if "loss" in r:     # JAX's formula: steps/s x B x T x 480 / 48000
            assert r["train_audio_s_per_s"] == pytest.approx(
                r["steps_per_s"] * 2 * 5 * 480 / 48_000, abs=0.06)
    assert TrainConfig.from_yaml(str(tmp_path / "port" / "config.yml")) == \
        TrainConfig(out_dir=str(tmp_path / "port"), **KW)


def test_trainer_preemption_resumes_exactly(tmp_path):
    """SIGTERM mid-run checkpoints at the step boundary; a Trainer that
    restores it and continues the stream ends where an uninterrupted run
    ends, bit for bit."""
    recs = np.random.default_rng(8).uniform(
        0.05, 0.95, (6, 6, 138)).astype(np.float32)
    ds = _Records(recs)
    kw = dict(batch_size=2, seq_len=6, train_max_steps=5,
              log_interval_steps=100, eval_interval_steps=100,
              save_interval_steps=100)

    def stream(skip=0, kill_at=None):
        for i, b in enumerate(datasets.batch_iterator(
                ds, 2, seed=1, skip_batches=skip)):
            if i == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    whole = Trainer(TrainConfig(out_dir=str(tmp_path / "whole"), **kw),
                    stream(), tensorboard=False, device="cpu")
    whole.run()
    cut_dir = str(tmp_path / "cut")
    cut = Trainer(TrainConfig(out_dir=cut_dir, **kw), stream(kill_at=2),
                  tensorboard=False, device="cpu")
    cut.run()                     # stops early via the signal
    step = int(cut.state.step)
    assert 1 <= step < 5
    assert ckpt.latest_checkpoint(cut_dir) == os.path.join(
        cut_dir, f"checkpoint-{step}.npz")
    again = Trainer(TrainConfig(out_dir=cut_dir, **kw), stream(skip=step),
                    tensorboard=False, device="cpu")
    assert again.restore() and int(again.state.step) == step
    again.run()
    a = _flat(str(tmp_path / "whole" / "checkpoint-5.npz"))
    b = _flat(os.path.join(cut_dir, "checkpoint-5.npz"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture
def feats_dir(tmp_path):
    """Five featgen-style record files (x30 applied by the loader) of
    20 frames: energies up to 1, g and r in [0.05, 0.95]."""
    d = tmp_path / "feats"
    d.mkdir()
    rng = np.random.default_rng(2)
    for i in range(5):
        rng.uniform(0.05, 0.95, (20, 138)).astype(np.float32).tofile(
            d / f"u{i}.f32")
    (d / "notes.txt").write_text("not a record file\n")
    return d


def test_split_dataset_matches_jax(feats_dir, tmp_path, capsys):
    dispatcher.main(["split-dataset", str(feats_dir), "--out-dir",
                     str(tmp_path / "port")])
    j_data.split_main([str(feats_dir), "--out-dir", str(tmp_path / "jax")])
    for name in ("train_filelist.txt", "dev_filelist.txt"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    assert len((tmp_path / "port" / "train_filelist.txt").read_text()
               .split()) == 4
    assert "train_filelist.txt: 4 files" in capsys.readouterr().out


def test_bin2h5_matches_jax(feats_dir, tmp_path):
    h5py = pytest.importorskip("h5py")
    src = str(feats_dir / "u0.f32")
    dispatcher.main(["bin2h5", src, str(tmp_path / "p.h5")])
    j_data.bin2h5_main([src, str(tmp_path / "j.h5")])
    with h5py.File(tmp_path / "p.h5") as p, h5py.File(tmp_path / "j.h5") as j:
        assert p["data"].dtype == j["data"].dtype == np.float32
        np.testing.assert_array_equal(p["data"][()], j["data"][()])
        assert p["data"].shape == (20, 138)


def _train_argv(feats_dir, lists, out, *extra):
    return ["train", "--train-filelist", str(lists / "train_filelist.txt"),
            "--dev-filelist", str(lists / "dev_filelist.txt"),
            "--out-dir", str(out), "--batch-size", "2", "--seq-len", "10",
            "--log-interval", "1", "--no-tensorboard", *extra]


@pytest.mark.parametrize("loader", ["device_data", "python"])
def test_train_command_matches_jax(feats_dir, tmp_path, loader,
                                   monkeypatch):
    """`train` from the same --pretrain params, with JAX's command beside
    it: 3 steps, history and checkpoint as JAX's.  The corpus on the
    device (the default for a small corpus), and the Python loader (the
    choice when the native library cannot be built)."""
    from percepnet_tpu_torch.io import native
    lists = tmp_path / "lists"
    dispatcher.main(["split-dataset", str(feats_dir), "--out-dir",
                     str(lists)])
    j_ckpt.save_params_npz(str(tmp_path / "init.npz"), jax.device_get(
        j_model.init_params(jax.random.PRNGKey(0))))
    extra = ["--max-steps", "3", "--pretrain", str(tmp_path / "init.npz")]
    if loader == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        extra += ["--device-data-mb", "0"]
    dispatcher.main(_train_argv(feats_dir, lists, tmp_path / "port",
                                *extra, "--device", "cpu"))
    if loader == "device_data":
        j_train.main(_train_argv(feats_dir, lists, tmp_path / "jax",
                                 *extra)[1:])
        _assert_runs_match(str(tmp_path / "jax"), str(tmp_path / "port"), 3)
    else:
        # JAX's command would take its native loader (another stream):
        # the port's Python loader is held to the device-data run, whose
        # index stream it shares
        dispatcher.main(_train_argv(feats_dir, lists, tmp_path / "dd",
                                    "--max-steps", "3", "--pretrain",
                                    str(tmp_path / "init.npz"),
                                    "--device", "cpu"))
        _assert_runs_match(str(tmp_path / "dd"), str(tmp_path / "port"), 3)


def test_train_command_resume_continues_the_run(feats_dir, tmp_path):
    """3 steps, then `train --max-steps 5` in the same --out-dir: the
    resumed run continues the data stream and ends bit for bit where an
    uninterrupted 5-step run ends."""
    lists = tmp_path / "lists"
    dispatcher.main(["split-dataset", str(feats_dir), "--out-dir",
                     str(lists)])
    for out, steps in (("a", "3"), ("a", "5"), ("b", "5")):
        dispatcher.main(_train_argv(feats_dir, lists, tmp_path / out,
                                    "--max-steps", steps, "--device", "cpu"))
    a = _flat(str(tmp_path / "a" / "checkpoint-5.npz"))
    b = _flat(str(tmp_path / "b" / "checkpoint-5.npz"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("flags", [["--distributed"],
                                   ["--coordinator", "localhost:1234",
                                    "--num-processes", "2",
                                    "--process-id", "0"]])
def test_train_distributed_is_refused(tmp_path, flags, capsys,
                                      monkeypatch):
    """What `train` still refuses, exit 2 before anything is written:
    --distributed with neither --coordinator nor torchrun's environment,
    and the group's flags without --distributed (JAX ignores them; a run
    that silently trained alone would be wrong)."""
    for key in cli_train.ENV_GROUP:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit) as e:
        dispatcher.main(["train", "--train-filelist", "x.lst", "--device",
                         "cpu", "--out-dir", str(tmp_path), *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("needs --coordinator" in err if "--distributed" in flags
            else "need --distributed" in err), err
    assert not any(tmp_path.iterdir())


def test_train_distributed_reads_torchrun_environment(monkeypatch):
    args = cli_train.build_parser().parse_args(
        ["--train-filelist", "x.lst", "--distributed"])
    for key, value in zip(cli_train.ENV_GROUP,
                          ("10.0.0.1", "29400", "3", "4")):
        monkeypatch.setenv(key, value)
    assert cli_train._group(args) == ("10.0.0.1:29400", 4, 3)
    args = cli_train.build_parser().parse_args(
        ["--train-filelist", "x.lst", "--distributed", "--coordinator",
         "h:1", "--num-processes", "2", "--process-id", "1"])
    assert cli_train._group(args) == ("h:1", 2, 1)


def test_train_distributed_on_a_missing_card_raises(tmp_path):
    """--distributed --device cuda without a card raises before a group is
    made; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatcher.main(["train", "--train-filelist", "x.lst", "--device",
                         "cuda", "--out-dir", str(tmp_path),
                         "--distributed", "--coordinator", "localhost:1",
                         "--num-processes", "1", "--process-id", "0"])
    assert not any(tmp_path.iterdir())


def test_trainer_refuses_a_device_corpus_in_a_process_group(monkeypatch,
                                                            tmp_path):
    """JAX's Trainer: device-resident data is single-process only."""
    monkeypatch.setattr(pm, "process_count", lambda: 2)
    cfg = TrainConfig(out_dir=str(tmp_path), **KW)
    with pytest.raises(ValueError, match="single-process"):
        Trainer(cfg, iter(()), device_data=np.zeros((4, 5, 138),
                                                    np.float32),
                device="cpu", tensorboard=False)


def test_trainer_mesh_is_one_device(tmp_path):
    """An in-process mesh of several devices is refused, naming
    --distributed (one process per card); a 1-device mesh names the
    device."""
    cfg = TrainConfig(out_dir=str(tmp_path), **KW)
    with pytest.raises(ValueError, match="--distributed"):
        Trainer(cfg, iter(()), mesh=make_mesh(["cpu", "cpu"]),
                tensorboard=False)
    tr = Trainer(cfg, iter(()), mesh=make_mesh(["cpu"]), tensorboard=False)
    assert tr.device == torch.device("cpu")


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_configs_load_as_jax_loads_them(path, tmp_path):
    """Every shipped config gives JAX's TrainConfig, field for field, and
    survives dump and load."""
    got = TrainConfig.from_yaml(path, out_dir="o")
    want = JTrainConfig.from_yaml(path, out_dir="o")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got.dump(str(tmp_path / "c.yml"))
    assert TrainConfig.from_yaml(str(tmp_path / "c.yml")) == got
