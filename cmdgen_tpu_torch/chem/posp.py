""".posp / .edgep pharmacophore-hypothesis file IO.

Behavioral equivalent of GCPG/utils/file_utils.py:8-142: the inference-time
pharmacophore input format. ``.posp`` lines are ``TYPE x y z`` with 3-D
coordinates whose Euclidean distances are mapped to bond-path distances by
the fitted linear map ``d*1.06068655 - 0.43105129``; ``.edgep`` files carry
the distance matrix directly. Emits the same dense padded arrays as
chem/ppgraph.py (pp_h [8,8], pp_e [8,8,1], pp_mask [8]).

A copy of ``cmdgen_tpu/chem/posp.py``.
"""
from __future__ import annotations

import random as _random
from pathlib import Path
from typing import List, Optional

import numpy as np

from cmdgen_tpu_torch.chem.ppgraph import MAX_NUM_PP_GRAPHS

IDX2PHAR = {
    0: "AROM", 1: "HYBL", 2: "POSC", 3: "HACC", 4: "HDON",
    5: "LHYBL", 6: "UNKNOWN",
}
PHAR2IDX = {v: k for k, v in IDX2PHAR.items()}

# per-type node-size sampling priors (file_utils.py:17-24)
IDX2SIZE = {
    0: ((5, 6), (0.5, 0.5)),
    1: ((3,), (1.0,)),
    2: ((1,), (1.0,)),
    3: ((1,), (1.0,)),
    4: ((1,), (1.0,)),
    5: ((6,), (1.0,)),
    6: ((1,), (1.0,)),
}

# 8-class DiffPhar family names -> posp type codes (get_phar/GMM_json.py:122-147)
FAMILY2POSP = {
    "Aromatic": "AROM", "Hydrophobe": "HYBL", "PosIonizable": "POSC",
    "Acceptor": "HACC", "Donor": "HDON", "LumpedHydrophobe": "LHYBL",
    "NegIonizable": "UNKNOWN", "others": "UNKNOWN",
}


def edis2sdis(edis: np.ndarray) -> np.ndarray:
    """Euclidean -> shortest-bond-path distance (file_utils.py:33-35)."""
    return edis * 1.06068655 - 0.43105129


def _format_type(types: List[str], rng: _random.Random):
    tp = [0.0] * 7
    size = -1
    for t in types:
        idx = PHAR2IDX[t]
        tp[idx] = 1.0
        sizes, probs = IDX2SIZE[idx]
        c = rng.choices(sizes, weights=probs, k=1)[0]
        size = max(c, size)
    return tp, float(size)


def points_to_graph(type_names: List[str], coords: np.ndarray,
                    rng: Optional[_random.Random] = None):
    """In-memory hypothesis (type codes + 3-D coords) ->
    (pp_h [8,8], pp_e [8,8,1], pp_mask [8]) — the .posp semantics without
    the file round-trip (used by the overlapped pipeline driver)."""
    rng = rng or _random.Random()
    k = len(type_names)
    if k > MAX_NUM_PP_GRAPHS:
        raise ValueError(f"{k} points > {MAX_NUM_PP_GRAPHS}")
    types, sizes = [], []
    for tnames in type_names:
        tp, size = _format_type(tnames.strip().split(" "), rng)
        types.append(tp)
        sizes.append(size)
    pos = np.asarray(coords, dtype=np.float64)
    dist = np.zeros((MAX_NUM_PP_GRAPHS, MAX_NUM_PP_GRAPHS), dtype=np.float32)
    for i in range(k):
        for j in range(i + 1, k):
            d = edis2sdis(np.linalg.norm(pos[i] - pos[j]))
            dist[i, j] = dist[j, i] = d
    pp_h = np.zeros((MAX_NUM_PP_GRAPHS, 8), dtype=np.float32)
    pp_h[:k, :7] = np.asarray(types, dtype=np.float32)
    pp_h[:k, 7] = np.asarray(sizes, dtype=np.float32)
    mask = np.zeros((MAX_NUM_PP_GRAPHS,), dtype=np.float32)
    mask[:k] = 1.0
    return pp_h, dist[..., None], mask


def load_posp(path, rng: Optional[_random.Random] = None):
    """Parse a .posp file -> (pp_h [8,8], pp_e [8,8,1], pp_mask [8])."""
    path = Path(path)
    tnames, pos = [], []
    for line in path.read_text().strip().split("\n"):
        parts = line.strip().split(" ")
        tnames.append(parts[0])
        pos.append(tuple(float(v) for v in parts[-3:]))
    try:
        return points_to_graph(tnames, np.asarray(pos), rng)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_edgep(path, rng: Optional[_random.Random] = None):
    """Parse a .edgep file (explicit distance matrix, file_utils.py:105-142)."""
    rng = rng or _random.Random()
    lines = Path(path).read_text().strip().split("\n")
    n = int(lines[0].strip())
    if n > MAX_NUM_PP_GRAPHS:
        raise ValueError(f"{path}: {n} points > {MAX_NUM_PP_GRAPHS}")
    types, sizes = [], []
    for i in range(1, 1 + n):
        idx, tnames = lines[i].strip().split(None, 1)
        assert int(idx) == i, f"{path}: bad node index line {i}"
        tp, size = _format_type(tnames.strip().split(" "), rng)
        types.append(tp)
        sizes.append(size)
    dist = np.zeros((MAX_NUM_PP_GRAPHS, MAX_NUM_PP_GRAPHS), dtype=np.float32)
    for ln in lines[1 + n : 1 + n + n * (n - 1) // 2]:
        u, v, d = ln.strip().split(" ")
        u, v = int(u) - 1, int(v) - 1
        dist[u, v] = dist[v, u] = float(d)
    pp_h = np.zeros((MAX_NUM_PP_GRAPHS, 8), dtype=np.float32)
    pp_h[:n, :7] = np.asarray(types, dtype=np.float32)
    pp_h[:n, 7] = np.asarray(sizes, dtype=np.float32)
    mask = np.zeros((MAX_NUM_PP_GRAPHS,), dtype=np.float32)
    mask[:n] = 1.0
    return pp_h, dist[..., None], mask


def load_phar_file(path):
    path = Path(path)
    fn = {".posp": load_posp, ".edgep": load_edgep}.get(path.suffix)
    if fn is None:
        raise ValueError(f'Invalid file path: "{path}"!')
    return fn(path)


def save_posp(path, type_names: List[str], coords: np.ndarray):
    """Write a .posp file (``TYPE x y z`` lines, GMM_json.py:149-155)."""
    lines = [
        f"{t} {x:.2f} {y:.2f} {z:.2f}"
        for t, (x, y, z) in zip(type_names, np.asarray(coords))
    ]
    Path(path).write_text("\n".join(lines) + "\n")
