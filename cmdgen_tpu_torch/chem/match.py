"""Pharmacophore match scoring for generated SMILES.

Behavioral equivalent of GCPG/utils/match_eval.py:36-252: perceive the
molecule's pharmacophore features, group candidates by the reference node's
(possibly multi-)type, enumerate assignment permutations, and score each
assignment by the fraction of pairwise bond-path distances within 1.21 of the
reference graph's edge lengths (early exit on a perfect match). The
multiprocessing wrapper preserves the sentinel codes:
  0..1 = score, -1 = invalid molecule, -2 = timeout, -3 = error.

A copy of ``cmdgen_tpu/chem/match.py``.
"""
from __future__ import annotations

from itertools import permutations, product
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmdgen_tpu_torch.chem.features import features_to_gcpg_indices, get_features
from cmdgen_tpu_torch.chem.mol import mol_from_smiles
from cmdgen_tpu_torch.chem.ppgraph import group_dist

DIST_TOLERANCE = 1.21  # match_eval.py:187
MAX_ASSIGNMENTS = 100_000  # safety cap on the permutation product


def extract_ref(pp_h: np.ndarray, pp_e: np.ndarray, pp_mask: np.ndarray):
    """Dense pp arrays -> (ref_dist dict, ref_type list of 1-based tuples),
    the reference's extract_dgl_info (match_eval.py:57-75)."""
    k = int(pp_mask.sum())
    ref_type = [
        tuple(int(i) + 1 for i in np.nonzero(pp_h[n, :7] > 0.5)[0])
        for n in range(k)
    ]
    ref_dist = {
        (i, j): float(pp_e[i, j, 0]) for i in range(k) for j in range(k) if i != j
    }
    return ref_dist, ref_type


def match_score(smiles: str, pp_h, pp_e, pp_mask) -> float:
    mol = mol_from_smiles(smiles)
    if mol is None:
        return -1.0
    ref_dist, ref_type = extract_ref(pp_h, pp_e, pp_mask)
    if not ref_type:
        return -1.0
    feats = get_features(mol)
    indexed = features_to_gcpg_indices(feats or [])

    all_types = {t for tt in ref_type for t in tt}
    candidates: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
    for t, atoms in indexed:
        if t in all_types:
            candidates.append(((t,), atoms))
    # merged multi-type candidates: same atom set, different single types
    # (match_eval.py:109-116)
    singles = list(candidates)
    for i in range(len(singles)):
        for j in range(i + 1, len(singles)):
            if singles[i][1] == singles[j][1] and singles[i][0] != singles[j][0]:
                merged = tuple(sorted(singles[i][0] + singles[j][0]))
                candidates.append((merged, singles[i][1]))

    # group reference nodes by their type tuple
    phar_mapping: Dict[Tuple[int, ...], List[int]] = {}
    for i, tt in enumerate(ref_type):
        phar_mapping.setdefault(tt, []).append(i)

    length = len(ref_type)
    phar_filter: List[List[Tuple[int, ...]]] = [[] for _ in range(length)]
    for phar, atoms in candidates:
        if phar in phar_mapping:
            for idx in phar_mapping[phar]:
                phar_filter[idx].append(atoms)

    # pairwise candidate distances via the precomputed all-pairs bond
    # matrix (native chemops when built), cached per atom-set pair
    from cmdgen_tpu_torch.chem.native import all_pairs_bond_dist

    dm = all_pairs_bond_dist(mol)
    dist_cache: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]], float] = {}

    def cand_dist(a, b) -> float:
        key = (a, b) if a <= b else (b, a)
        if key not in dist_cache:
            # match-side semantics (match_eval.py:30-43 cal_dist_all):
            # an identical atom set scores 0 only for singletons and
            # max_size*0.2 otherwise — unlike the corpus-side group
            # distance (smiles2ppgraph.py:191-205 = group_dist), which
            # gives 0 for any identical set. The two reference functions
            # genuinely differ here.
            if key[0] == key[1] and len(key[0]) > 1:
                dist_cache[key] = len(key[0]) * 0.2
            else:
                dist_cache[key] = group_dist(mol, key[0], key[1], dm)
        return dist_cache[key]

    groups = list(phar_mapping.values())
    group_elements = []
    n_places = []
    for g in groups:
        elems = list(range(len(phar_filter[g[0]])))
        if len(elems) < len(g):
            elems.extend([None] * (len(g) - len(elems)))
        group_elements.append(elems)
        n_places.append(len(g))

    best = 0.0
    n_seen = 0
    for combo in product(
        *[permutations(e, n) for e, n in zip(group_elements, n_places)]
    ):
        assignment: List[Optional[Tuple[int, ...]]] = [None] * length
        for g_ele, g_idx in zip(combo, groups):
            for a, b in zip(g_ele, g_idx):
                assignment[b] = None if a is None else phar_filter[b][a]
        correct = 0
        wrong = 0
        for p in range(length):
            for q in range(p + 1, length):
                if assignment[p] is None or assignment[q] is None:
                    d = 100.0
                else:
                    d = abs(
                        cand_dist(assignment[p], assignment[q])
                        - ref_dist[(p, q)]
                    )
                if d < DIST_TOLERANCE:
                    correct += 1
                else:
                    wrong += 1
        total = correct + wrong
        score = correct / total if total else 0.0
        best = max(best, score)
        if best == 1.0:
            return 1.0
        n_seen += 1
        if n_seen >= MAX_ASSIGNMENTS:
            break
    return best


def _worker(args):
    import signal

    smiles, pp_h, pp_e, pp_mask, timeout = args

    class _Timeout(Exception):
        pass

    def _raise(*_):
        raise _Timeout

    try:
        if timeout:
            signal.signal(signal.SIGALRM, _raise)
            signal.alarm(int(timeout))
        try:
            return match_score(smiles, pp_h, pp_e, pp_mask)
        finally:
            if timeout:
                signal.alarm(0)
    except _Timeout:
        return -2.0
    except Exception:
        return -3.0


def get_match_scores(
    pp_graphs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    smiles_list: Sequence[str],
    n_workers: int = 8,
    timeout: float = 20.0,
) -> List[float]:
    """Batched scoring with a process pool and per-item timeouts
    (match_eval.py:211-252). Codes: -1 invalid, -2 timeout, -3 error."""
    assert len(pp_graphs) == len(smiles_list)
    args = [
        (s, g[0], g[1], g[2], timeout) for s, g in zip(smiles_list, pp_graphs)
    ]
    if n_workers <= 1:
        return [_worker(a) for a in args]
    import multiprocessing as mp

    # spawn, not fork: a forked child would inherit the parent's CUDA
    # context, which CUDA does not support in a child process
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_workers, maxtasksperchild=32) as pool:
        return list(pool.imap(_worker, args))
