"""Gasteiger-Marsili PEOE partial charges.

The reference preps docking inputs with tools that compute Gasteiger
charges — obabel for ligand SDF->PDBQT (DiffPhar/analysis/docking.py:21-24)
and MGLTools ``prepare_receptor4.py`` for receptors
(DiffPhar/analysis/docking_py27.py:6-25). Neither binary is assumed
installed, so this module implements the same published algorithm (Gasteiger &
Marsili, Tetrahedron 36 (1980) 3219: partial equalization of orbital
electronegativities, 6 damped iterations) directly on the self-contained
``chem.mol.Mol`` graph.

Implicit hydrogens are expanded to pseudo-atoms for the iteration (each
carries its own charge); callers can merge non-polar H charges back into
their carbon for AD4 united-atom output (``heavy_charges_ad4``).

A copy of ``cmdgen_tpu/chem/gasteiger.py`` on the port's ``chem/mol.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from cmdgen_tpu_torch.chem.mol import Mol

# (a, b, c) of chi(q) = a + b q + c q^2, by element/hybridization
# (Gasteiger & Marsili 1980 Table 1, the parameter set OpenBabel ships).
_PARAMS: Dict[str, Tuple[float, float, float]] = {
    "H":     (7.17, 6.24, -0.56),
    "C.3":   (7.98, 9.18, 1.88),
    "C.2":   (8.79, 9.32, 1.51),
    "C.1":   (10.39, 9.45, 0.73),
    "N.3":   (11.54, 10.82, 1.36),
    "N.2":   (12.87, 11.15, 0.85),
    "N.1":   (15.68, 11.70, -0.27),
    "O.3":   (14.18, 12.92, 1.39),
    "O.2":   (17.07, 13.79, 0.47),
    "F":     (14.66, 13.85, 2.31),
    "Cl":    (11.00, 9.69, 1.35),
    "Br":    (10.08, 8.47, 1.16),
    "I":     (9.90, 7.96, 0.96),
    "S.3":   (10.14, 9.13, 1.38),
    "S.2":   (10.14, 9.13, 1.38),
    "P.3":   (8.90, 8.24, 0.96),
}
# charge-flow damping denominator: chi at q=+1 of the DONATING atom;
# hydrogen uses the fixed 20.02 from the paper
_H_DENOM = 20.02
_N_ITER = 6


def _hyb_key(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    s = a.symbol
    if s in ("H", "F", "Cl", "Br", "I"):
        return s
    orders = [mol.bonds[bi].order for _, bi in mol.neighbors(i)]
    aromatic = a.aromatic
    if s == "C":
        if 3 in orders or orders.count(2) >= 2:
            return "C.1"
        return "C.2" if (2 in orders or aromatic) else "C.3"
    if s == "N":
        if 3 in orders:
            return "N.1"
        return "N.2" if (2 in orders or aromatic) else "N.3"
    if s == "O":
        return "O.2" if (2 in orders or aromatic) else "O.3"
    if s == "S":
        return "S.2" if (2 in orders or aromatic) else "S.3"
    if s == "P":
        return "P.3"
    return "C.3"  # fallback parameters for rare elements


def _chi(p: Tuple[float, float, float], q: float) -> float:
    a, b, c = p
    return a + b * q + c * q * q


def gasteiger_charges(mol: Mol) -> Tuple[List[float], List[List[float]]]:
    """PEOE charges on the heavy-atom graph with implicit-H expansion.

    Returns ``(heavy, h_per_atom)``: one charge per Mol atom plus a list of
    per-implicit-hydrogen charges for each atom (``len == total_h(i)``).
    Total charge is conserved (= sum of formal charges).
    """
    n = mol.n_atoms
    params: List[Tuple[float, float, float]] = []
    q: List[float] = []
    bonds: List[Tuple[int, int]] = [(b.a1, b.a2) for b in mol.bonds]
    h_of: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        params.append(_PARAMS[_hyb_key(mol, i)])
        q.append(float(mol.atoms[i].charge))
    for i in range(n):
        for _ in range(mol.total_h(i)):
            hid = len(params)
            params.append(_PARAMS["H"])
            q.append(0.0)
            bonds.append((i, hid))
            h_of[i].append(hid)

    for it in range(1, _N_ITER + 1):
        damp = 0.5 ** it
        dq = [0.0] * len(q)
        for i, j in bonds:
            chi_i = _chi(params[i], q[i])
            chi_j = _chi(params[j], q[j])
            if chi_i == chi_j:
                continue
            # charge flows from the less to the more electronegative atom;
            # denominator = chi+ of the donor (H: fixed 20.02)
            donor = i if chi_i < chi_j else j
            denom = _H_DENOM if params[donor] == _PARAMS["H"] else sum(
                params[donor]
            )
            flow = (chi_j - chi_i) / denom * damp
            dq[i] += flow
            dq[j] -= flow
        for k in range(len(q)):
            q[k] += dq[k]

    heavy = q[:n]
    h_charges = [[q[h] for h in h_of[i]] for i in range(n)]
    return heavy, h_charges


def heavy_charges_ad4(
    mol: Mol,
    polar: Optional[Sequence[bool]] = None,
) -> Tuple[List[float], List[List[float]]]:
    """AD4 united-atom charge partition: non-polar hydrogens (on C) merge
    their charge into the parent atom; polar hydrogens (on N/O/S — the HD
    atoms a PDBQT keeps) stay separate. Returns (per-heavy-atom charge,
    per-heavy-atom list of retained polar-H charges)."""
    heavy, h_charges = gasteiger_charges(mol)
    out_h: List[List[float]] = []
    for i in range(mol.n_atoms):
        is_polar = (
            polar[i] if polar is not None
            else mol.atoms[i].symbol in ("N", "O", "S")
        )
        if is_polar:
            out_h.append(list(h_charges[i]))
        else:
            heavy[i] += sum(h_charges[i])
            out_h.append([])
    return heavy, out_h
