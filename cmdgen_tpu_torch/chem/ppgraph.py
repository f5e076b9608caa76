"""SMILES -> random pharmacophore graph (training-time featurization).

Behavioral equivalent of smiles2ppgraph (GCPG/utils/smiles2ppgraph.py:14-235):
sample a target point count from the empirical prior via stochastic universal
sampling, take that many perceived features, merge identical-atom-set
features into multi-type nodes, sort by mean atom index, and build the
fully-connected graph whose edge lengths are minimum bond-path distances with
bond-type weights (single 1.0 / double 0.87 / aromatic 0.91 / other 0.78)
plus a 0.2·group-size penalty. Emits dense padded arrays instead of a
DGLGraph:

  pp_h [8, 8]   node features (7-bit type one-hot ‖ size scalar)
  pp_e [8, 8, 1] pairwise distances
  pp_mask [8]
  mapping [n_atoms, 8]  atom↔feature incidence

A copy of ``cmdgen_tpu/chem/ppgraph.py``.
"""
from __future__ import annotations

import random as _random
from typing import Optional, Tuple

import numpy as np

from cmdgen_tpu_torch.chem.features import features_to_gcpg_indices, get_features
from cmdgen_tpu_torch.chem.mol import Mol, mol_from_smiles

MAX_NUM_PP_GRAPHS = 8

# empirical P(number of pharmacophore points) (smiles2ppgraph.py:135-137)
NUM_PP_SUPPORT = [3, 4, 5, 6, 7]
NUM_PP_PROBS = [0.086, 0.0864, 0.389, 0.495, 0.0273]

BOND_WEIGHTS = {1: 1.0, 2: 0.87, 3: 0.78}
AROMATIC_WEIGHT = 0.91


def sample_probability(elements, probs, n, rng: _random.Random):
    """Stochastic universal sampling (smiles2ppgraph.py:14-27)."""
    out = []
    m = len(probs)
    index = int(rng.random() * m)
    mw = max(probs)
    beta = 0.0
    for _ in range(n):
        beta += rng.random() * 2.0 * mw
        while beta > probs[index]:
            beta -= probs[index]
            index = (index + 1) % m
        out.append(elements[index])
    return out


def bond_path_dist(mol: Mol, start: int, end: int) -> float:
    """Weighted length of the unweighted-BFS shortest path
    (smiles2ppgraph.py:38-82: BFS parents, then sum bond-type weights)."""
    if start == end:
        return 0.0
    parent = {start: None}
    queue = [start]
    while queue:
        cur = queue.pop(0)
        if cur == end:
            break
        for nb, _ in mol.neighbors(cur):
            if nb not in parent:
                parent[nb] = cur
                queue.append(nb)
    if end not in parent:
        return 100.0  # disconnected
    dist = 0.0
    cur = end
    while parent[cur] is not None:
        b = mol.bond_between(cur, parent[cur])
        if b.aromatic:
            dist += AROMATIC_WEIGHT
        else:
            dist += BOND_WEIGHTS.get(b.order, 0.78)
        cur = parent[cur]
    return dist


def group_dist(mol: Mol, atoms_i, atoms_j, dm=None) -> float:
    """Feature-group distance (smiles2ppgraph.py:193-210).

    ``dm`` is an optional precomputed all-pairs bond-distance matrix
    (chem/native.py) — one BFS sweep per molecule instead of one per pair.
    """
    set_i, set_j = set(atoms_i), set(atoms_j)
    max_size = max(len(set_i), len(set_j))
    if set_i == set_j:
        return 0.0
    if set_i & set_j:
        return max_size * 0.2
    if dm is not None:
        d = float(min(dm[a, b] for a in set_i for b in set_j))
    else:
        d = min(bond_path_dist(mol, a, b) for a in set_i for b in set_j)
    if max_size == 1:
        return d
    return d + max_size * 0.2


def smiles_to_ppgraph(
    smiles: str, rng: Optional[_random.Random] = None
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Returns (pp_h [8,8], pp_e [8,8,1], pp_mask [8], mapping [n_atoms,8])
    or None for invalid molecules / no features."""
    rng = rng or _random.Random()
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    feats = get_features(mol)
    if not feats:
        return None
    indexed = features_to_gcpg_indices(feats)  # [(type 1..7, atoms)]
    rng.shuffle(indexed)
    (num,) = sample_probability(NUM_PP_SUPPORT, NUM_PP_PROBS, 1, rng)
    chosen = indexed[: int(num)] if len(indexed) >= int(num) else indexed

    # merge same-atom-set features into multi-type nodes
    merged = {}
    for t, atoms in chosen:
        merged.setdefault(atoms, set()).add(t)
    nodes = [(sorted(types), atoms) for atoms, types in merged.items()]
    # sort by mean atom index (smiles2ppgraph.py:166-177)
    nodes.sort(key=lambda n: sum(n[1]) / len(n[1]))
    nodes = nodes[:MAX_NUM_PP_GRAPHS]
    k = len(nodes)

    type_oh = np.zeros((MAX_NUM_PP_GRAPHS, 7), dtype=np.float32)
    size = np.zeros((MAX_NUM_PP_GRAPHS,), dtype=np.float32)
    for i, (types, atoms) in enumerate(nodes):
        for t in types:
            type_oh[i, t - 1] = 1.0
        size[i] = len(atoms)

    from cmdgen_tpu_torch.chem.native import all_pairs_bond_dist

    dm = all_pairs_bond_dist(mol) if k > 1 else None
    dist = np.zeros((MAX_NUM_PP_GRAPHS, MAX_NUM_PP_GRAPHS), dtype=np.float32)
    for i in range(k):
        for j in range(i + 1, k):
            dij = group_dist(mol, nodes[i][1], nodes[j][1], dm)
            dji = group_dist(mol, nodes[j][1], nodes[i][1], dm)
            d = min(dij, dji)  # symmetrization (smiles2ppgraph.py:217-224)
            dist[i, j] = dist[j, i] = d

    mask = np.zeros((MAX_NUM_PP_GRAPHS,), dtype=np.float32)
    mask[:k] = 1.0

    mapping = np.zeros((mol.n_atoms, MAX_NUM_PP_GRAPHS), dtype=np.float32)
    for i, (types, atoms) in enumerate(nodes):
        for a in atoms:
            mapping[a, i] = 1.0

    pp_h = np.concatenate([type_oh, size[:, None]], axis=1)
    pp_e = dist[..., None]
    return pp_h, pp_e, mask, mapping
