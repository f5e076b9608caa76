"""Symmetry-aware RMSD between molecule conformers.

Behavioral equivalent of the reference's isomorphism-matched RMSD
(DiffPhar/utils.py:148-195): enumerate graph isomorphisms between the two
molecular graphs (element-labeled) and take the minimum heavy-atom RMSD over
atom matchings — symmetric molecules (e.g. para-substituted rings) would
otherwise report spuriously large RMSDs.

A copy of ``cmdgen_tpu/chem/rmsd.py`` with its own isomorphism
enumerator in place of networkx's ``GraphMatcher``, and the port's
Kabsch for ``align=True``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from cmdgen_tpu_torch.chem.mol import Mol


def _graph(mol: Mol):
    """(element labels, {neighbour: bond order} per atom)."""
    labels = [a.symbol for a in mol.atoms]
    adj = [dict() for _ in mol.atoms]
    for b in mol.bonds:
        adj[b.a1][b.a2] = b.order
        adj[b.a2][b.a1] = b.order
    return labels, adj


def isomorphisms(mol1: Mol, mol2: Mol) -> Iterator[Dict[int, int]]:
    """Every element- and bond-order-preserving isomorphism of mol1's graph
    onto mol2's, as {atom of mol1: atom of mol2}, by depth-first extension
    (VF2-style): atoms of mol1 are placed in breadth-first order, each
    candidate must agree in element and degree, and every bond to an atom
    already placed must exist in mol2 with the same order (and no other
    bond to a placed atom)."""
    l1, a1 = _graph(mol1)
    l2, a2 = _graph(mol2)
    n = len(l1)
    if n != len(l2) or sum(map(len, a1)) != sum(map(len, a2)):
        return
    if sorted(zip(l1, map(len, a1))) != sorted(zip(l2, map(len, a2))):
        return
    order: List[int] = []
    seen = [False] * n
    for root in range(n):
        if seen[root]:
            continue
        seen[root] = True
        queue = [root]
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in sorted(a1[u]):
                if not seen[v]:
                    seen[v] = True
                    queue.append(v)
    mapping: Dict[int, int] = {}
    used = [False] * n

    def fits(u: int, v: int) -> bool:
        if used[v] or l1[u] != l2[v] or len(a1[u]) != len(a2[v]):
            return False
        placed = 0
        for w, bo in a1[u].items():
            if w in mapping:
                if a2[v].get(mapping[w]) != bo:
                    return False
                placed += 1
        # no bond of v to a placed atom that u lacks
        return placed == sum(1 for y in a2[v] if used[y])

    def extend(k: int) -> Iterator[Dict[int, int]]:
        if k == n:
            yield dict(mapping)
            return
        u = order[k]
        anchor = next((w for w in a1[u] if w in mapping), None)
        cands = sorted(a2[mapping[anchor]]) if anchor is not None else range(n)
        for v in cands:
            if fits(u, v):
                mapping[u] = v
                used[v] = True
                yield from extend(k + 1)
                del mapping[u]
                used[v] = False

    yield from extend(0)


def isomorphic_rmsd(
    mol1: Mol,
    coords1: np.ndarray,
    mol2: Mol,
    coords2: np.ndarray,
    max_matches: int = 1000,
    align: bool = False,
) -> Optional[float]:
    """Minimum RMSD over graph isomorphisms; None if graphs don't match.

    align=True additionally Kabsch-aligns per matching (the reference
    compares already-posed conformers, so default is direct RMSD)."""
    best = None
    for k, mapping in enumerate(isomorphisms(mol1, mol2)):
        if k >= max_matches:
            break
        idx1 = np.fromiter(mapping.keys(), dtype=np.int64)
        idx2 = np.fromiter(mapping.values(), dtype=np.int64)
        p = coords1[idx1]
        q = coords2[idx2]
        if align:
            import torch

            from cmdgen_tpu_torch.ops.kabsch import aligned_rmsd

            r = float(aligned_rmsd(torch.as_tensor(p, dtype=torch.float32),
                                   torch.as_tensor(q, dtype=torch.float32)))
        else:
            r = float(np.sqrt(((p - q) ** 2).sum(-1).mean()))
        if best is None or r < best:
            best = r
    return best
