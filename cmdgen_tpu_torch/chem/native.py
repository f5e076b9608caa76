"""ctypes bindings for the native chemops library (csrc/chemops.cpp).

Builds with g++ on first use; every entry point has a pure-Python
fallback so the framework works without a toolchain. The hot op is the
all-pairs weighted bond-path distance matrix consumed by the pharmacophore
graph builder and match scorer.

A copy of ``cmdgen_tpu/chem/native.py`` that builds the port's own
``cmdgen_tpu_torch/csrc/chemops.cpp`` into ``cmdgen_tpu_torch/_build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "chemops.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _lib_path() -> Path:
    """The library's path, named by a hash of the source and the flags so
    that an edited source is rebuilt."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libchemops-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source with g++ to a temporary name, renamed into place
    (processes that build at once each write their own file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, timeout=120, check=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _lib_path()
        if not path.exists():
            try:
                _build(path)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.all_pairs_bond_dist.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.all_pairs_bond_dist.restype = None
        _LIB = lib
        return _LIB


def all_pairs_bond_dist(mol) -> np.ndarray:
    """[n,n] weighted bond-path distances (native; Python BFS fallback).

    Weights match smiles2ppgraph.py:38-82: single 1.0, double 0.87,
    aromatic 0.91, other 0.78; disconnected pairs 100.0.
    """
    from cmdgen_tpu_torch.chem.ppgraph import AROMATIC_WEIGHT, BOND_WEIGHTS

    n = mol.n_atoms
    bonds = np.asarray(
        [[b.a1, b.a2] for b in mol.bonds], dtype=np.int32
    ).reshape(-1, 2)
    weights = np.asarray(
        [
            AROMATIC_WEIGHT if b.aromatic else BOND_WEIGHTS.get(b.order, 0.78)
            for b in mol.bonds
        ],
        dtype=np.float32,
    )
    lib = get_lib()
    out = np.empty((n, n), dtype=np.float32)
    if lib is not None:
        lib.all_pairs_bond_dist(
            np.int32(n), np.int32(len(bonds)),
            np.ascontiguousarray(bonds), np.ascontiguousarray(weights), out,
        )
        return out
    # fallback: one BFS per source
    adj = [[] for _ in range(n)]
    for (u, v), w in zip(bonds, weights):
        adj[u].append((int(v), float(w)))
        adj[v].append((int(u), float(w)))
    out.fill(100.0)
    for s in range(n):
        parent = {s: None}
        pw = {s: 0.0}
        queue = [s]
        while queue:
            cur = queue.pop(0)
            for nb, w in adj[cur]:
                if nb not in parent:
                    parent[nb] = cur
                    pw[nb] = w
                    queue.append(nb)
        for t in parent:
            d, cur = 0.0, t
            while parent[cur] is not None:
                d += pw[cur]
                cur = parent[cur]
            out[s, t] = d
    return out
