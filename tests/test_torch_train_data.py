"""The port's training data and checkpoints against the JAX package's on
the CPU: record datasets, iterators and h5 reads batch for batch (bit for
bit), the native IO binding against the port's own PCM codec and Python
loader, and full-state checkpoints that move between the two packages
(keys, dtypes and shapes equal; one further step after the move within
the Adam bound of tests/test_torch_train.py: losses 1e-5 relative,
params 1e-5 absolute)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.io import native as j_native
from percepnet_tpu.io.flat_npz import params_to_flat as j_params_to_flat
from percepnet_tpu.train import checkpoint as j_ckpt
from percepnet_tpu.train import datasets as j_datasets
from percepnet_tpu.train import state as j_ts
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.io import native, pcm
from percepnet_tpu_torch.io.flat_npz import params_from_flat, params_to_flat
from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.train import checkpoint as ckpt
from percepnet_tpu_torch.train import datasets
from percepnet_tpu_torch.train import state as ts
from percepnet_tpu_torch.train.trainer import Trainer, TrainConfig

torch.set_num_threads(2)

STEP_LOSS_REL = 1e-5
PARAM_ABS = 1e-5


@pytest.fixture
def record_files(tmp_path):
    """Four raw record files of 25, 40, 9 and 31 frames."""
    rng = np.random.default_rng(3)
    files = []
    for i, t in enumerate((25, 40, 9, 31)):
        rec = rng.uniform(0, 1, (t, C.RECORD_DIM)).astype(np.float32)
        path = tmp_path / f"r{i}.f32"
        rec.tofile(path)
        files.append(str(path))
    return files


@pytest.mark.parametrize("shard,nshards", [(0, 1), (0, 2), (1, 2)])
def test_record_dataset_matches_jax(record_files, shard, nshards):
    """Chunks, the x30 on columns 0:68, and the shard split, bit for bit."""
    got = datasets.RecordListDataset(record_files, 10, shard_id=shard,
                                     num_shards=nshards)
    want = j_datasets.RecordListDataset(record_files, 10, shard_id=shard,
                                        num_shards=nshards)
    assert got.files == want.files and len(got) == len(want) > 0
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(
        datasets.load_record_file(record_files[0]),
        j_datasets.load_record_file(record_files[0]))
    np.testing.assert_array_equal(datasets.load_all_chunks(got),
                                  j_datasets.load_all_chunks(want))
    for a, b in zip(datasets.split_xy(datasets.load_all_chunks(got)),
                    j_datasets.split_xy(j_datasets.load_all_chunks(want))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 7), (False, 0)])
def test_iterators_match_jax(record_files, shuffle, seed):
    """batch_iterator and index_iterator yield JAX's stream: 3 epochs of
    4-chunk batches over 9 chunks, batch for batch."""
    got_ds = datasets.RecordListDataset(record_files, 10)
    want_ds = j_datasets.RecordListDataset(record_files, 10)
    kw = dict(shuffle=shuffle, seed=seed, epochs=3)
    got = list(datasets.batch_iterator(got_ds, 4, **kw))
    want = list(j_datasets.batch_iterator(want_ds, 4, **kw))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got_idx = list(datasets.index_iterator(len(got_ds), 4, **kw))
    want_idx = list(j_datasets.index_iterator(len(want_ds), 4, **kw))
    for a, b in zip(got_idx, want_idx):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_skip_batches_continues_the_stream(record_files):
    """A stream started skip_batches in is the rest of the full stream,
    across epochs, in both iterators (how a resumed run continues)."""
    ds = datasets.RecordListDataset(record_files, 10)
    full = list(datasets.batch_iterator(ds, 2, seed=5, epochs=4))
    rest = list(datasets.batch_iterator(ds, 2, seed=5, epochs=4,
                                        skip_batches=7))
    assert len(rest) == len(full) - 7
    for a, b in zip(rest, full[7:]):
        np.testing.assert_array_equal(a, b)
    idx = datasets.index_iterator(len(ds), 2, seed=5, skip_batches=7)
    full_idx = list(datasets.index_iterator(len(ds), 2, seed=5, epochs=4))
    for want in full_idx[7:]:
        np.testing.assert_array_equal(next(idx), want)


def test_iterators_raise_instead_of_hanging_on_tiny_dataset():
    class Tiny:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return np.zeros((4, 138), np.float32)

    with pytest.raises(ValueError, match="never yield"):
        next(datasets.batch_iterator(Tiny(), 8))
    with pytest.raises(ValueError, match="never yield"):
        next(datasets.index_iterator(2, 8))
    # finite-epoch iterators may legitimately yield nothing
    assert list(datasets.batch_iterator(Tiny(), 8, epochs=1)) == []


def test_h5_datasets_match_jax(tmp_path):
    """H5Dataset (windows, NO x30: the reference quirk) and H5DirDataset,
    read as JAX reads them."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(11)
    data = rng.uniform(0, 1, (23, 138)).astype(np.float32)
    path = str(tmp_path / "data.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data)
    got, want = datasets.H5Dataset(path, 10), j_datasets.H5Dataset(path, 10)
    assert len(got) == len(want) == 2
    for i in range(2):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[1], data[10:20])
    got.close()
    (tmp_path / "dir").mkdir()
    for i in range(3):
        with h5py.File(tmp_path / "dir" / f"u{i}.h5", "w") as f:
            f.create_dataset("data", data=np.full((4, 138), i, np.float32))
    got_dir = datasets.H5DirDataset(str(tmp_path / "dir"))
    want_dir = j_datasets.H5DirDataset(str(tmp_path / "dir"))
    assert len(got_dir) == len(want_dir) == 3
    np.testing.assert_array_equal(got_dir[2], want_dir[2])


def test_h5_without_h5py_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        datasets.H5Dataset(str(tmp_path / "x.h5"))


def test_native_pcm_matches_port_pcm(tmp_path):
    """The native codec writes the bytes io.pcm writes (clamp and C
    truncation included) and reads them back alike."""
    if not native.available():
        pytest.skip("no make/g++ to build the native IO library")
    rng = np.random.default_rng(0)
    x = (rng.uniform(-1.3, 1.3, 10_000) * 32768.0).astype(np.float32)
    a, b = str(tmp_path / "n.pcm"), str(tmp_path / "p.pcm")
    native.write_pcm16(a, x)
    pcm.write_pcm16(b, x)
    np.testing.assert_array_equal(np.fromfile(a, "<i2"),
                                  np.fromfile(b, "<i2"))
    for norm in (False, True):
        np.testing.assert_allclose(native.read_pcm16(a, normalize=norm),
                                   pcm.read_pcm16(b, normalize=norm),
                                   atol=1e-7)
    assert native.LIBRARY.exists()


def test_native_loader_matches_python_chunks_and_jax(record_files):
    """Every batch of the port's native loader is made of the Python
    dataset's chunks (x30 applied), and its stream is JAX's binding's."""
    if not native.available():
        pytest.skip("no make/g++ to build the native IO library")
    ds = datasets.RecordListDataset(record_files, 10)
    chunks = [ds[i] for i in range(len(ds))]
    got = native.NativeBatchLoader(record_files, 10, 3, seed=2, n_threads=2)
    want = j_native.NativeBatchLoader(record_files, 10, 3, seed=2,
                                      n_threads=2)
    assert got.num_chunks() == want.num_chunks() == len(ds)
    for _ in range(5):
        b = next(got)
        np.testing.assert_array_equal(b, next(want))
        for row in b:
            assert any(np.array_equal(row, c) for c in chunks)
    got.close()
    want.close()


# --- checkpoints ------------------------------------------------------------

def _port_model(j_params):
    return params_from_flat({k: np.array(v) for k, v in
                             j_params_to_flat(jax.device_get(j_params))
                             .items()})


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (2, 20, 70)).astype(np.float32),
            rng.uniform(0.05, 0.95, (2, 20, 68)).astype(np.float32))


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("clip_norm", [None, 1.0])
def test_checkpoints_move_between_packages(tmp_path, clip_norm):
    """Both optimizer layouts: after one step in each package, the port's
    checkpoint has JAX's keys, dtypes and shapes; each package resumes
    the other's checkpoint, and one more step matches the package that
    did not move."""
    tx = j_ts.make_optimizer(1e-4, clip_norm)
    jstate = j_ts.init_train_state(jax.random.PRNGKey(0), tx)
    jstep, _ = j_ts.make_jitted_steps(tx)
    opt = ts.make_optimizer(1e-4, clip_norm)
    state = ts.init_train_state(_port_model(jstate.params), opt)
    (x0, y0), (x1, y1) = _batch(0), _batch(1)
    jstate, _ = jstep(jstate, x0, y0)
    ts.train_step(state, torch.from_numpy(x0), torch.from_numpy(y0), opt)

    j_path, p_path = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    j_ckpt.save_checkpoint(j_path, jax.device_get(jstate))
    ckpt.save_checkpoint(p_path, state)
    jf, pf = _flat(j_path), _flat(p_path)
    assert sorted(jf) == sorted(pf)
    for k in jf:
        assert jf[k].dtype == pf[k].dtype and jf[k].shape == pf[k].shape, k
        np.testing.assert_allclose(pf[k], jf[k], atol=PARAM_ABS)

    # JAX resumes the port's checkpoint; the port resumes JAX's
    j_from_p = j_ckpt.load_checkpoint(
        p_path, j_ts.init_train_state(jax.random.PRNGKey(1), tx))
    p_from_j = ts.init_train_state(_port_model(jstate.params), opt)
    ckpt.load_checkpoint(j_path, p_from_j)
    assert int(p_from_j.step) == int(j_from_p.step) == 1
    for name, (js, ps) in {"jax_resumes_port": (j_from_p, state),
                           "port_resumes_jax": (jstate, p_from_j)}.items():
        js, jl = jstep(js, x1, y1)
        pl = ts.train_step(ps, torch.from_numpy(x1), torch.from_numpy(y1),
                           opt)
        assert abs(float(jl) - float(pl)) <= STEP_LOSS_REL * float(jl)
        j_ckpt.save_checkpoint(str(tmp_path / "j2.npz"), jax.device_get(js))
        ckpt.save_checkpoint(str(tmp_path / "p2.npz"), ps)
        a, b = _flat(str(tmp_path / "j2.npz")), _flat(str(tmp_path / "p2.npz"))
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=PARAM_ABS,
                                       err_msg=f"{name} {k}")
        assert int(a["step"]) == int(b["step"]) == 2


def test_checkpoint_roundtrip_and_latest(tmp_path):
    """Save then load restores every array bit for bit; the newest
    checkpoint-<step>.npz wins, other names are ignored."""
    opt = ts.make_optimizer(1e-4)
    state = ts.init_train_state(
        PercepNet(torch.Generator().manual_seed(3)), opt)
    x, y = _batch(2)
    ts.train_step(state, torch.from_numpy(x), torch.from_numpy(y), opt)
    for step in (2, 10, 9):
        ckpt.save_checkpoint(str(tmp_path / f"checkpoint-{step}.npz"), state)
    (tmp_path / "checkpoint-99.npz.tmp").write_bytes(b"")
    (tmp_path / "params.npz").write_bytes(b"")
    path = ckpt.latest_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "checkpoint-10.npz")
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    fresh = ts.init_train_state(
        PercepNet(torch.Generator().manual_seed(4)), opt)
    ckpt.load_checkpoint(path, fresh)
    a, b = ckpt.state_to_flat(state), ckpt.state_to_flat(fresh)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert ckpt.checkpoint_step(path) == 1


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails midway leaves the old checkpoint whole and no
    temp file behind."""
    opt = ts.make_optimizer(1e-4)
    state = ts.init_train_state(
        PercepNet(torch.Generator().manual_seed(3)), opt)
    path = str(tmp_path / "checkpoint-0.npz")
    ckpt.save_checkpoint(path, state)
    before = (tmp_path / "checkpoint-0.npz").read_bytes()

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    state.step.fill_(5)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, state)
    assert (tmp_path / "checkpoint-0.npz").read_bytes() == before
    assert os.listdir(tmp_path) == ["checkpoint-0.npz"]


def test_restore_across_optimizer_layout_change(tmp_path):
    """A JAX checkpoint of another optimizer layout (no apply_if_finite
    wrapper) restores params and step in the port's Trainer, with a fresh
    optimizer, and training continues."""
    tx_old = j_ts.make_optimizer(1e-4, skip_nonfinite=False)
    old = j_ts.init_train_state(jax.random.PRNGKey(0), tx_old)
    old = old._replace(step=jnp.asarray(7, jnp.int32))
    j_ckpt.save_checkpoint(str(tmp_path / "checkpoint-7.npz"),
                           jax.device_get(old))
    rec = np.random.default_rng(9).uniform(
        0.05, 0.95, (2, 6, 138)).astype(np.float32)

    def it():
        while True:
            yield rec

    cfg = TrainConfig(batch_size=2, seq_len=6, train_max_steps=8,
                      log_interval_steps=100, eval_interval_steps=100,
                      save_interval_steps=100, out_dir=str(tmp_path))
    tr = Trainer(cfg, it(), tensorboard=False, device="cpu")
    assert tr.restore()
    assert int(tr.state.step) == 7
    got = params_to_flat(tr.state.model)
    for k, v in j_params_to_flat(jax.device_get(old.params)).items():
        np.testing.assert_array_equal(got[k], v)
    assert int(tr.state.opt_state["inner_state/0/count"]) == 0
    tr.run()
    assert int(tr.state.step) == 8
    assert (tmp_path / "checkpoint-8.npz").exists()
