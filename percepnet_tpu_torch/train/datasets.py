"""Training datasets over 138-float feature records, on numpy: the port's
copy of percepnet_tpu/train/datasets.py, batch for batch the same stream.

The reference's three loaders (rnn_train.py:28-103):
  * RecordListDataset  <- CppRawListDataset: a filelist of raw float32
    record files, each reshaped (T, 138); band-energy columns 0:68 are
    scaled x30 (rnn_train.py:48-49) because the C++ generator only scales
    the copy it feeds the net, not the dump (denoise.cpp:491-493,761-773).
  * H5Dataset          <- h5Dataset: one contiguous h5 `data` dataset
    sliced into fixed windows; NO x30 (the reference quirk, kept).
  * H5DirDataset       <- h5DirDataset: directory of per-utterance h5 files.
The h5 datasets need h5py, imported when one is opened.

Beside them: deterministic host sharding (shard_id/num_shards), and
iterators yielding [B, T, 138] batches (or int32 index batches into a
corpus kept on the device) with a seeded reshuffle every epoch.
`skip_batches` starts either stream that many batches in without
loading them, so a run resumed at step s sees batch s next.
"""

from __future__ import annotations

import os
from typing import Iterator, Sequence

import numpy as np

from percepnet_tpu_torch import constants as C

FEATURE_COLS = slice(0, C.NB_FEATURES)            # 0:70
TARGET_COLS = slice(C.NB_FEATURES, C.RECORD_DIM)  # 70:138
SCALE_COLS = slice(0, 2 * C.NB_BANDS)             # 0:68, x30


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5 record files need the h5py package") from e
    return h5py


def load_record_file(path: str, *, scale: bool = True) -> np.ndarray:
    """One raw float32 record file -> [T, 138] (x30 on cols 0:68)."""
    x = np.memmap(path, np.float32, "r")
    t = x.shape[0] // C.RECORD_DIM
    x = np.array(x[: t * C.RECORD_DIM]).reshape(t, C.RECORD_DIM)
    if scale:
        x[:, SCALE_COLS] *= C.FEATURE_SCALE
    return x


def read_filelist(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def split_filelist(paths: Sequence[str], train_frac: float = 0.8):
    """Deterministic train/dev split (utils/split_feature_dataset.py:7-16)."""
    n = int(len(paths) * train_frac)
    return list(paths[:n]), list(paths[n:])


class RecordListDataset:
    """Fixed-length sequences from a list of raw record files.

    Each file yields floor(T / seq_len) non-overlapping [seq_len, 138]
    chunks (the reference feeds whole 2000-frame files; chunking handles
    variable-length files the same way its h5 path does).
    """

    def __init__(self, files: Sequence[str], seq_len: int = 2000, *,
                 scale: bool = True,
                 shard_id: int = 0, num_shards: int = 1):
        self.files = list(files)[shard_id::num_shards]
        self.seq_len = seq_len
        self.scale = scale
        self._index: list[tuple[int, int]] = []
        for fi, path in enumerate(self.files):
            t = os.path.getsize(path) // (4 * C.RECORD_DIM)
            for c in range(t // seq_len):
                self._index.append((fi, c * seq_len))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int) -> np.ndarray:
        fi, start = self._index[i]
        x = np.memmap(self.files[fi], np.float32, "r")
        t = x.shape[0] // C.RECORD_DIM
        x = np.array(x[: t * C.RECORD_DIM]).reshape(t, C.RECORD_DIM)
        chunk = x[start : start + self.seq_len].copy()
        if self.scale:
            chunk[:, SCALE_COLS] *= C.FEATURE_SCALE
        return chunk


class H5Dataset:
    """Windows over one contiguous h5 `data` dataset (rnn_train.py:90-103).

    Faithful to the reference: window_size chunks, NO x30 scaling.
    """

    def __init__(self, path: str, window_size: int = 500, *,
                 shard_id: int = 0, num_shards: int = 1):
        self._h5 = _h5py().File(path, "r")
        self._data = self._h5["data"]
        self.window_size = window_size
        n = self._data.shape[0] // window_size
        self._starts = list(range(0, n * window_size, window_size)
                            )[shard_id::num_shards]

    def __len__(self) -> int:
        return len(self._starts)

    def __getitem__(self, i: int) -> np.ndarray:
        s = self._starts[i]
        return np.asarray(self._data[s : s + self.window_size],
                          np.float32)

    def close(self) -> None:
        self._h5.close()


class H5DirDataset:
    """One h5 file per utterance in a directory (rnn_train.py:60-88)."""

    def __init__(self, root: str, *, shard_id: int = 0, num_shards: int = 1):
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith((".h5", ".hdf5")))[shard_id::num_shards]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        with _h5py().File(self.files[i], "r") as f:
            return np.asarray(f["data"], np.float32)


def _batch_orders(n: int, batch_size: int, *, shuffle: bool, seed: int,
                  drop_last: bool, epochs: int | None,
                  skip_batches: int) -> Iterator[np.ndarray]:
    """The index stream both iterators share: each epoch a seeded
    permutation of range(n) cut into batches; the first skip_batches
    batches are drawn and dropped."""
    if drop_last and epochs is None and n < batch_size:
        raise ValueError(
            f"{n} chunks < batch_size {batch_size}; the infinite iterator "
            "would never yield (next() would hang)")
    rng = np.random.default_rng(seed)
    epoch = pos = 0
    while epochs is None or epoch < epochs:
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        for i in range(0, n, batch_size):
            idx = order[i : i + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            if pos >= skip_batches:
                yield idx
            pos += 1
        epoch += 1


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   epochs: int | None = None,
                   skip_batches: int = 0) -> Iterator[np.ndarray]:
    """Yield [B, T, 138] batches; reshuffles every epoch.

    `epochs=None` iterates forever (the reference trains by max_steps,
    not epochs).
    """
    for idx in _batch_orders(len(dataset), batch_size, shuffle=shuffle,
                             seed=seed, drop_last=drop_last, epochs=epochs,
                             skip_batches=skip_batches):
        yield np.stack([dataset[int(j)] for j in idx])


def split_xy(batch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, T, 138] -> (features [B, T, 70], targets [B, T, 68])."""
    return batch[..., FEATURE_COLS], batch[..., TARGET_COLS]


def load_all_chunks(dataset) -> np.ndarray:
    """Materialize every chunk of a dataset: [N, seq_len, 138] float32,
    for the corpus kept on the device (a few-hour corpus is hundreds of
    MB; the reference's 500 h recipe about 25 GB)."""
    if len(dataset) == 0:
        raise ValueError("empty dataset")
    out = np.empty((len(dataset),) + dataset[0].shape, np.float32)
    for i in range(len(dataset)):
        out[i] = dataset[i]
    return out


def index_iterator(n: int, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   epochs: int | None = None,
                   skip_batches: int = 0) -> Iterator[np.ndarray]:
    """Yield int32 index batches with batch_iterator's exact stream
    semantics (seeded per-epoch reshuffle), for device-resident data."""
    for idx in _batch_orders(n, batch_size, shuffle=shuffle, seed=seed,
                             drop_last=drop_last, epochs=epochs,
                             skip_batches=skip_batches):
        yield idx.astype(np.int32)
