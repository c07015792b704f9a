"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by plain `nvcc` into an object, all sources at
once, and the objects are linked into one shared library with a C
interface, `build/percepnet_tpu_torch/libpercepnet_kernels.so` under the
checkout's root, loaded with ctypes.  No PyTorch header is compiled, so a
build takes seconds.  The library is rebuilt only when a source is newer
than it.  Nothing is built at import: the first launch builds.

Processes that build at once (card tests under xdist, two scripts on one
checkout) take turns: the stale check, compile and link run under an
exclusive lock on `build/percepnet_tpu_torch/.lock`, objects go to a
directory of the building process's own, and the library replaces the old
one in one rename.  A process that waited finds the library fresh.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "percepnet_tpu_torch"
LIBRARY = BUILD_DIR / "libpercepnet_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# ctypes signatures of the C entry points: pointers and the stream as
# c_void_p (a plain int would be cut to 32 bits), ints as c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
# s_pad, period, taps, window, out; batch, n_frames, n_pad, x_offset,
# frames per tile, column slices; stream
_COMB = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {
    "percepnet_comb_windows_f32": _COMB,
    "percepnet_comb_windows_bf16": _COMB,
    "percepnet_comb_rows_f32": _COMB,
    "percepnet_comb_rows_bf16": _COMB,
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _is_stale() -> bool:
    """True when the library is missing or older than a source or header."""
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    deps = _sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def _compile(nvcc: str, workdir: pathlib.Path) -> pathlib.Path:
    """Compile every source into workdir, all at once, and link them
    there; returns the library's path in workdir."""
    jobs = []
    for src in _sources():
        obj = workdir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    lib = workdir / LIBRARY.name
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib),
            *(str(obj) for _, obj, _ in jobs)]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}")
    return lib


def build() -> bool:
    """Compile every csrc/*.cu (one nvcc each, all started together) and
    link the library, unless it is up to date.  Returns True if it
    compiled.  Raises with the compiler's output when a step fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when closed
        if not _is_stale():
            return False
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(
                prefix=f"build.{os.getpid()}.", dir=BUILD_DIR) as work:
            os.replace(_compile(nvcc, pathlib.Path(work)), LIBRARY)
        return True


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built first if it is stale; loaded once."""
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
