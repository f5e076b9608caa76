"""Molecule-set quality metrics.

Behavioral equivalents of BasicMolecularMetrics / MoleculeProperties /
CategoricalDistribution (DiffPhar/analysis/metrics.py:12-248): the
validity → connectivity → uniqueness → novelty chain, QED/SA/logP/Lipinski
averages, Tanimoto diversity, and KL divergence of categorical type
histograms against the training distribution.

A copy of ``cmdgen_tpu/chem/metrics.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmdgen_tpu_torch.chem import descriptors as d
from cmdgen_tpu_torch.chem.mol import canonical_smiles, mol_from_smiles


def validity(smiles_list: Sequence[str]) -> Tuple[List[str], float]:
    """Valid = parses + sanitizes. Returns (valid canonical smiles, ratio)."""
    valid = []
    for s in smiles_list:
        c = canonical_smiles(s)
        if c is not None and c != "":
            valid.append(c)
    return valid, len(valid) / max(len(smiles_list), 1)


def connectivity(smiles_list: Sequence[str]) -> Tuple[List[str], float]:
    """Connected = single fragment (metrics.py filters to largest fragment;
    here a molecule counts as connected when it has no '.' components)."""
    connected = [s for s in smiles_list if "." not in s]
    return connected, len(connected) / max(len(smiles_list), 1)


def largest_fragment(smiles: str) -> Optional[str]:
    """Keep the largest '.'-separated component (molecule_builder.py:176-184)."""
    c = canonical_smiles(smiles)
    if c is None:
        return None
    frags = c.split(".")
    best = max(frags, key=lambda f: (mol_from_smiles(f) or _EmptyMol()).n_atoms)
    return best


class _EmptyMol:
    n_atoms = 0


def uniqueness(valid: Sequence[str]) -> Tuple[List[str], float]:
    unique = list(dict.fromkeys(valid))
    return unique, len(unique) / max(len(valid), 1)


def novelty(unique: Sequence[str], train_set: set) -> Tuple[List[str], float]:
    novel = [s for s in unique if s not in train_set]
    return novel, len(novel) / max(len(unique), 1)


def evaluate_set(
    smiles_list: Sequence[str], train_set: Optional[set] = None
) -> Dict[str, float]:
    """Full metric chain over a generated set (metrics.py:66-154 +
    MoleculeProperties.evaluate)."""
    valid, v = validity(smiles_list)
    connected, c = connectivity(valid)
    unique, u = uniqueness(connected)
    out = {"validity": v, "connectivity": c, "uniqueness": u}
    if train_set is not None:
        novel, n = novelty(unique, train_set)
        out["novelty"] = n
    if unique:
        qeds, sas, logps, lips = [], [], [], []
        for s in unique:
            qeds.append(d.qed(s))
            sas.append(d.sa_score(s))
            logps.append(d.crippen_logp(s))
            lips.append(d.lipinski(s))
        out.update(
            qed=float(np.nanmean(qeds)),
            sa=float(np.nanmean(sas)),
            logp=float(np.nanmean(logps)),
            lipinski=float(np.nanmean(lips)),
            diversity=diversity(unique),
        )
    return out


def diversity(smiles_list: Sequence[str], max_mols: int = 200) -> float:
    """1 - mean pairwise Tanimoto (metrics.py:231-248)."""
    smiles_list = list(smiles_list)[:max_mols]
    if len(smiles_list) < 2:
        return 0.0
    fps = [d.morgan_fingerprint(s) for s in smiles_list]
    total, count = 0.0, 0
    for i in range(len(fps)):
        for j in range(i + 1, len(fps)):
            total += d.tanimoto(fps[i], fps[j])
            count += 1
    return 1.0 - total / max(count, 1)


def categorical_kl(
    generated_hist: np.ndarray, reference_hist: np.ndarray, eps: float = 1e-10
) -> float:
    """KL(generated ‖ reference) over normalized type histograms
    (CategoricalDistribution.kl_divergence, metrics.py:12-33)."""
    p = np.asarray(generated_hist, dtype=np.float64) + eps
    q = np.asarray(reference_hist, dtype=np.float64) + eps
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum(p * np.log(p / q)))


def type_histogram(type_indices: Sequence[int], n_classes: int) -> np.ndarray:
    hist = np.zeros(n_classes, dtype=np.int64)
    for t in type_indices:
        hist[int(t)] += 1
    return hist
