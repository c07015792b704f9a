"""The port stands alone: neither percepnet_tpu_torch nor chip_smoke.py
imports JAX, optax or the JAX package, and chip_smoke.py refuses to run
without a CUDA card or without the repository around it."""

import ast
import pathlib
import shutil
import subprocess
import sys

import jax  # noqa: F401  (JAX and torch share each test process)
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "percepnet_tpu")
SOURCES = sorted((ROOT / "percepnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in \
                ("import_module", "__import__"):
            names.append(node.args[0].value)
    return names


def test_sources_found():
    assert len(SOURCES) > 10
    assert (ROOT / "percepnet_tpu_torch" / "csrc" / "comb.cu").exists()
    pkg = ROOT / "percepnet_tpu_torch"
    for rel in ("train/loss.py", "train/state.py", "train/checkpoint.py",
                "train/datasets.py", "train/trainer.py", "cli/train.py",
                "cli/data.py", "io/native.py"):
        assert pkg / rel in SOURCES, rel


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
