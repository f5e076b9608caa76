"""Hygiene of the port: it imports no JAX and nothing of ``cmdgen_tpu``,
every module imports with JAX blocked, and entry points called without a
device raise where CUDA is absent (no silent move to the CPU)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cmdgen_tpu_torch.convert import load_port_checkpoint
from cmdgen_tpu_torch.device import resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "cmdgen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _package_files():
    """The package's Python sources (not the kernel build directory)."""
    return sorted(f for f in PKG.rglob("*.py") if "_build" not in f.relative_to(PKG).parts)


def _port_files():
    return _package_files() + [REPO / "chip_smoke.py"]


def _modules():
    out = []
    for f in _package_files():
        rel = f.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_source_scan_no_jax_and_no_cmdgen_tpu_imports():
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in FORBIDDEN or top == "cmdgen_tpu":
                    bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (
        f"import sys; {blocked}; sys.modules['cmdgen_tpu'] = None\n"
        "import importlib, importlib.util\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and sys.modules[k] is not None"
        " for k in sys.modules)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_entry_points_without_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_port_checkpoint(PKG / "assets" / "qrun_aa")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
