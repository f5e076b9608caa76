"""Build and load the port's CUDA sources and the kernels' plans.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into shared libraries with
a plain C interface, at first use, into ``cmdgen_tpu_torch/_build/``: one
library per variant of the source (``VARIANTS``), each holding one group of
its kernel's instantiations (``-DEGNN_VARIANT=v``), so that the groups
compile in parallel. ``csrc/egnn_plan.cpp``, the kernels' launch plans and
limits (``csrc/egnn_plan.h``, which the kernels include too), is compiled by
``g++`` (``plan_library``), on the CPU as on the card. A library's file
name carries a hash of its source, the headers and the flags, so an edited
source is rebuilt; the compiler writes to a temporary name that is renamed
into place. Libraries are loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("egnn_msgpass", "egnn_fused")
# each source's variants (csrc/<name>.cu: EGNN_VARIANT): K1's regular and
# ragged widths, then K3's; K2's float, float ragged, bf16 mma, bf16
# block_gemm, and the float and bf16 mma ones chunked
VARIANTS = {"egnn_msgpass": 4, "egnn_fused": 6}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
PLAN_SOURCE = "egnn_plan"
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[Tuple[str, int], ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(variant: int) -> Sequence[str]:
    return (*NVCC_FLAGS, f"-DEGNN_VARIANT={variant}")


def _headers():
    return sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")])


def _library_path(name: str, variant: int) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in _headers():
        h.update(header.read_bytes())
    h.update(" ".join(_flags(variant)).encode())
    return BUILD_DIR / f"lib{name}.{variant}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES, ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every variant of the named sources whose library is missing,
    all at once.

    Returns {"name.variant": compiler output} for the libraries compiled
    now (with ``ptxas_verbose``, ptxas's register and shared memory
    report). Raises RuntimeError with the compiler's output when a compile
    fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        for variant in range(VARIANTS[name]):
            lib = _library_path(name, variant)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *_flags(variant)]
            if ptxas_verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[f"{name}.{variant}"] = (lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    logs, failed = {}, []
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (source.variant):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, variant: int) -> ctypes.CDLL:
    """The loaded library of variant ``variant`` of csrc/<name>.cu, built
    first (with the source's other variants) if needed."""
    with _lock:
        lib = _loaded.get((name, variant))
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name, variant)))
            _loaded[(name, variant)] = lib
        return lib


def _plan_path() -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{PLAN_SOURCE}.cpp").read_bytes())
    for header in _headers():
        h.update(header.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{PLAN_SOURCE}-{h.hexdigest()[:16]}.so"


def plan_library() -> ctypes.CDLL:
    """The loaded library of csrc/egnn_plan.cpp, built with g++ first if
    needed. Raises RuntimeError with the compiler's output when the compile
    fails."""
    with _lock:
        lib = _loaded.get((PLAN_SOURCE, 0))
        if lib is None:
            path = _plan_path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{PLAN_SOURCE}.cpp")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed for {PLAN_SOURCE}.cpp:\n{proc.stdout}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            _loaded[(PLAN_SOURCE, 0)] = lib
        return lib
