"""ctypes binding of the native host-IO library (cpp/percepnet_io.cpp),
the port's own: the C++ source and its Makefile are shared with the JAX
package, the library is built for the port alone.

Provides:
  * NativeBatchLoader: a multithreaded prefetching record-batch loader
    (the training input pipeline; replaces DataLoader workers and the
    run.sh process fan-out);
  * read_pcm16 / write_pcm16: the PCM codec with reference semantics.

The first use builds `build/percepnet_tpu_torch/libpercepnet_io.so` with
cpp/Makefile (`make -C` a per-process copy of cpp/, g++, no other
dependency) under an exclusive lock, and renames it into place, so
processes that start at once do not load a half-written library.
`available()` is False when it cannot be built (no make or g++): callers
then use the pure-Python io.pcm and train.datasets, which is a choice of
host loader, not of device.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import logging
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Sequence

import numpy as np

from percepnet_tpu_torch import constants as C

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_CPP_DIR = _ROOT / "cpp"
BUILD_DIR = _ROOT / "build" / "percepnet_tpu_torch"
LIBRARY = BUILD_DIR / "libpercepnet_io.so"

log = logging.getLogger("percepnet_tpu_torch.io")


def _build() -> bool:
    """Build the library unless it is newer than its source; False when
    the toolchain is missing or the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = _CPP_DIR / "percepnet_io.cpp"
    with open(BUILD_DIR / ".io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when closed
        if LIBRARY.exists() and \
                LIBRARY.stat().st_mtime >= source.stat().st_mtime:
            return True
        with tempfile.TemporaryDirectory(
                prefix=f"io.{os.getpid()}.", dir=BUILD_DIR) as work:
            for name in ("Makefile", source.name):
                shutil.copy2(_CPP_DIR / name, work)
            try:
                subprocess.run(["make", "-s", "-C", work], check=True,
                               capture_output=True, text=True)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                log.warning("native IO library not built: %s",
                            getattr(e, "stderr", None) or e)
                return False
            os.replace(os.path.join(work, LIBRARY.name), LIBRARY)
        return True


@functools.lru_cache(maxsize=None)
def _load():
    if not _build():
        return None
    lib = ctypes.CDLL(str(LIBRARY))
    lib.pn_loader_create.restype = ctypes.c_void_p
    lib.pn_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int]
    lib.pn_loader_num_chunks.restype = ctypes.c_int64
    lib.pn_loader_num_chunks.argtypes = [ctypes.c_void_p]
    lib.pn_loader_failed_reads.restype = ctypes.c_int64
    lib.pn_loader_failed_reads.argtypes = [ctypes.c_void_p]
    lib.pn_loader_next.restype = ctypes.c_int
    lib.pn_loader_next.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.pn_loader_destroy.restype = None
    lib.pn_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.pn_pcm_read.restype = ctypes.c_int64
    lib.pn_pcm_read.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_int64, ctypes.c_float]
    lib.pn_pcm_write.restype = ctypes.c_int
    lib.pn_pcm_write.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int64, ctypes.c_float]
    return lib


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable; use "
                           "io.pcm / train.datasets instead")
    return lib


class NativeBatchLoader:
    """Infinite prefetching iterator of [B, T, 138] float32 batches.

    Fixed-length chunks, a seeded reshuffle every epoch and host sharding,
    as train.datasets.batch_iterator; the file IO, x30 scaling and batch
    assembly run on C++ threads that stay ahead of the device.  Its
    shuffle is the C++ library's (mt19937, seed + epoch), not numpy's,
    and it has no skip: a resumed run starts its stream anew.
    """

    def __init__(self, files: Sequence[str], seq_len: int, batch: int, *,
                 record_dim: int = C.RECORD_DIM, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 0,
                 scale: bool = True, n_threads: int = 4,
                 queue_cap: int = 4):
        self._lib = _lib()
        arr = (ctypes.c_char_p * len(files))(
            *[os.fsencode(f) for f in files])
        self._h = self._lib.pn_loader_create(
            arr, len(files), seq_len, batch, record_dim, shard_id,
            num_shards, seed, 2 * C.NB_BANDS if scale else 0,
            float(C.FEATURE_SCALE), n_threads, queue_cap)
        self._shape = (batch, seq_len, record_dim)
        self._warned_failures = 0
        if self.num_chunks() == 0:
            self.close()
            raise ValueError(
                "no training chunks: every listed file is unreadable or "
                f"shorter than seq_len={seq_len} records")

    def num_chunks(self) -> int:
        return int(self._lib.pn_loader_num_chunks(self._h))

    def failed_reads(self) -> int:
        """Chunk reads that failed mid-training (file deleted/truncated)
        and were zero-filled; surfaced so corruption is never silent."""
        return int(self._lib.pn_loader_failed_reads(self._h))

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty(self._shape, np.float32)
        rc = self._lib.pn_loader_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise StopIteration
        failed = self.failed_reads()
        if failed > self._warned_failures:
            log.warning("native loader: %d chunk read(s) failed and were "
                        "zero-filled (deleted/truncated file?)", failed)
            self._warned_failures = failed
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.pn_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def read_pcm16(path: str, normalize: bool = False) -> np.ndarray:
    """Native PCM read; same signature/semantics as io.pcm.read_pcm16."""
    n = os.path.getsize(path) // 2
    out = np.empty(n, np.float32)
    got = _lib().pn_pcm_read(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, 1.0 / 32768.0 if normalize else 1.0)
    if got < 0:
        raise IOError(f"pcm read failed: {path}")
    return out[:got]


def write_pcm16(path: str, x: np.ndarray, scale: float = 1.0) -> None:
    """Native PCM write with C truncation semantics (io.pcm.write_pcm16)."""
    x = np.ascontiguousarray(x, np.float32)
    rc = _lib().pn_pcm_write(
        os.fsencode(path), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.shape[0], scale)
    if rc != 0:
        raise IOError(f"pcm write failed: {path}")
