"""ops.kernels.build under concurrency, on the CPU with a stub compiler.

Two processes build at once into one build directory.  The stub (a
Python script standing in for nvcc) logs its calls, sleeps and writes its
-o file in two halves, so that a build that raced another would link a
half-written object or leave a half-written library.  Both processes
must return, the library must be whole, and the compile step must have
run for one build only, with its objects in a directory of its own.
"""

import json
import pathlib
import subprocess
import sys

from percepnet_tpu_torch.ops import kernels

TIMEOUT_S = 60                           # per process; the build takes ~1 s

STUB = r'''#!{python}
import pathlib, sys, time
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\n")
time.sleep(0.3)
if "-c" in args:
    content = "object of " + pathlib.Path(args[args.index("-c") + 1]).name + "\n"
else:
    content = "".join(pathlib.Path(a).read_text() for a in args if a.endswith(".o"))
out.write_text(content[: len(content) // 2])
time.sleep(0.2)
with open(out, "a") as f:
    f.write(content[len(content) // 2:])
'''

RUN = r'''
import importlib.util, json, pathlib
spec = importlib.util.spec_from_file_location("kernels", {kernels!r})
k = importlib.util.module_from_spec(spec)
spec.loader.exec_module(k)
k._nvcc = lambda: {stub!r}
k.BUILD_DIR = pathlib.Path({build!r})
k.LIBRARY = k.BUILD_DIR / "libpercepnet_kernels.so"
print(json.dumps(k.build()))
'''


def _start(code):
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_two_processes_build_once_and_both_load(tmp_path):
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    build = tmp_path / "build"
    code = RUN.format(kernels=kernels.__file__, stub=str(stub),
                      build=str(build))
    procs = [_start(code), _start(code)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            assert proc.returncode == 0, err
            results.append(json.loads(out))
    finally:
        for proc in procs:
            proc.kill()
    assert sorted(results) == [False, True]     # one compiled, one waited

    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    calls = [line.split() for line in log.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert len(compiles) == len(sources) and len(links) == 1
    objects = [pathlib.Path(c[c.index("-o") + 1]) for c in compiles]
    workdir = objects[0].parent
    assert all(o.parent == workdir for o in objects)
    assert workdir.parent == build and workdir.name.startswith("build.")
    assert not workdir.exists()                  # removed after the link

    library = build / "libpercepnet_kernels.so"
    linked = [pathlib.Path(a).name for a in links[0] if a.endswith(".o")]
    assert library.read_text() == "".join(
        f"object of {name[:-2]}.cu\n" for name in linked)
    assert sorted(p.name for p in build.iterdir()) == [
        ".lock", "libpercepnet_kernels.so"]


def test_a_fresh_library_is_not_rebuilt(tmp_path, monkeypatch):
    """The stale check runs under the lock: with the library newer than
    every source, build() neither compiles nor needs a compiler."""
    library = tmp_path / "libpercepnet_kernels.so"
    library.write_text("built")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "LIBRARY", library)

    def no_nvcc():
        raise AssertionError("compiled a fresh library")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    assert kernels.build() is False
    assert (tmp_path / ".lock").exists()
