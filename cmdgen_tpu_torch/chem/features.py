"""Pharmacophore feature perception.

Behavioral stand-in for RDKit's ChemicalFeatures/BaseFeatures.fdef factory
used throughout the reference (DiffPhar/process_crossdock.py:83-102,
GCPG/utils/smiles2ppgraph.py:120-133, GCPG/utils/match_eval.py:80-82).
This image has no RDKit, so features are perceived with rule-based graph
patterns approximating the BaseFeatures families:

  Aromatic, Hydrophobe, PosIonizable, NegIonizable, Acceptor, Donor,
  LumpedHydrophobe  (+ 'others' bucket)

If RDKit becomes importable, ``get_features`` transparently prefers it.

Class index conventions preserved:
- DiffPhar 8-class: {Aromatic:0, Hydrophobe:1, PosIonizable:2,
  NegIonizable:3, Acceptor:4, Donor:5, LumpedHydrophobe:6, others:7}
  (DiffPhar/constants.py:99-100)
- GCPG 7-bit (1-based with NegIonizable folded into others):
  {Aromatic:1, Hydrophobe:2, PosIonizable:3, Acceptor:4, Donor:5,
  LumpedHydrophobe:6, others:7} (smiles2ppgraph.py:128-131)

A copy of ``cmdgen_tpu/chem/features.py``. RDKit is imported lazily
where it is installed; without it the built-in rules below run.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from cmdgen_tpu_torch.chem.mol import Mol, mol_from_smiles

PHAR_FAMILIES = [
    "Aromatic", "Hydrophobe", "PosIonizable", "NegIonizable",
    "Acceptor", "Donor", "LumpedHydrophobe", "others",
]
PHAR_IDX_8 = {f: i for i, f in enumerate(PHAR_FAMILIES)}
GCPG_MAPPING = {
    "Aromatic": 1, "Hydrophobe": 2, "PosIonizable": 3,
    "Acceptor": 4, "Donor": 5, "LumpedHydrophobe": 6,
}

Feature = Tuple[str, Tuple[int, ...]]  # (family, sorted atom ids)


def _has_rdkit() -> bool:
    try:
        import rdkit  # noqa: F401

        return True
    except ImportError:
        return False


def get_features(mol_or_smiles) -> Optional[List[Feature]]:
    """Perceive pharmacophore features. Accepts a SMILES string or a Mol.

    Returns None for invalid molecules.
    """
    if isinstance(mol_or_smiles, str):
        if _has_rdkit():
            return _rdkit_features(mol_or_smiles)
        mol = mol_from_smiles(mol_or_smiles)
        if mol is None:
            return None
    else:
        mol = mol_or_smiles
    return _builtin_features(mol)


def _rdkit_features(smiles: str) -> Optional[List[Feature]]:
    import os

    from rdkit import Chem, RDConfig
    from rdkit.Chem import ChemicalFeatures

    m = Chem.MolFromSmiles(smiles)
    if m is None:
        return None
    factory = ChemicalFeatures.BuildFeatureFactory(
        os.path.join(RDConfig.RDDataDir, "BaseFeatures.fdef")
    )
    out = []
    for f in factory.GetFeaturesForMol(m):
        fam = f.GetFamily()
        if fam not in PHAR_IDX_8:
            fam = "others"
        out.append((fam, tuple(sorted(f.GetAtomIds()))))
    return out


# ------------------------------------------------------------ builtin rules

def _is_carbonyl_carbon(mol: Mol, i: int) -> bool:
    if mol.atoms[i].symbol != "C":
        return False
    return any(
        mol.bonds[bi].order == 2 and mol.atoms[nb].symbol in ("O", "S")
        for nb, bi in mol.neighbors(i)
    )


def _neighbor_symbols(mol: Mol, i: int) -> List[str]:
    return [mol.atoms[nb].symbol for nb in mol.heavy_neighbors(i)]


def _builtin_features(mol: Mol) -> List[Feature]:
    feats: List[Feature] = []
    n = mol.n_atoms
    in_ring = mol.ring_membership()
    arings = mol.aromatic_rings()
    rings = mol.rings()

    # ---- Aromatic: one feature per aromatic ring
    for r in arings:
        feats.append(("Aromatic", tuple(sorted(r))))

    # ---- Donor: N/O with >=1 H (charge 0 or +1 for N)
    for i, a in enumerate(mol.atoms):
        h = mol.total_h(i)
        if h < 1:
            continue
        if a.symbol == "N" and a.charge >= 0:
            feats.append(("Donor", (i,)))
        elif a.symbol == "O" and a.charge == 0:
            feats.append(("Donor", (i,)))

    # ---- Acceptor
    for i, a in enumerate(mol.atoms):
        if a.symbol == "O":
            # exclude nitro/aromatic-furan oxygens roughly like BaseFeatures
            if a.aromatic:
                continue
            nitro = any(
                mol.atoms[nb].symbol == "N"
                and sum(
                    mol.bonds[b2].order == 2 and mol.atoms[n2].symbol == "O"
                    for n2, b2 in mol.neighbors(nb)
                )
                >= 1
                and mol.atoms[nb].charge > 0
                for nb in mol.heavy_neighbors(i)
            )
            if not nitro:
                feats.append(("Acceptor", (i,)))
        elif a.symbol == "N" and a.charge <= 0:
            if a.aromatic:
                # pyridine-type N (no H, 2 ring bonds) accepts
                if mol.total_h(i) == 0 and mol.degree(i) == 2:
                    feats.append(("Acceptor", (i,)))
                continue
            # exclude amide/sulfonamide N and quaternary/sp2-conjugated N
            conjugated = any(
                _is_carbonyl_carbon(mol, nb)
                or (
                    mol.atoms[nb].symbol == "S"
                    and any(
                        mol.bonds[b2].order == 2
                        for _, b2 in mol.neighbors(nb)
                    )
                )
                for nb in mol.heavy_neighbors(i)
            )
            has_double = any(
                mol.bonds[bi].order >= 2 for _, bi in mol.neighbors(i)
            )
            if not conjugated and not has_double and mol.degree(i) + mol.total_h(i) <= 3:
                feats.append(("Acceptor", (i,)))

    # ---- PosIonizable
    used_pos = set()
    # guanidine / amidine: C(=N)(N...) groups -> whole group is one feature
    for i, a in enumerate(mol.atoms):
        if a.symbol != "C" or a.aromatic:
            continue
        n_dbl = [
            nb for nb, bi in mol.neighbors(i)
            if mol.atoms[nb].symbol == "N" and mol.bonds[bi].order == 2
        ]
        n_sgl = [
            nb for nb, bi in mol.neighbors(i)
            if mol.atoms[nb].symbol == "N" and mol.bonds[bi].order == 1
        ]
        if len(n_dbl) == 1 and len(n_sgl) >= 1:
            group = tuple(sorted([i] + n_dbl + n_sgl))
            feats.append(("PosIonizable", group))
            used_pos.update(group)
    for i, a in enumerate(mol.atoms):
        if i in used_pos:
            continue
        if a.charge > 0:
            feats.append(("PosIonizable", (i,)))
        elif a.symbol == "N" and not a.aromatic and a.charge == 0:
            # basic amine: sp3 N not adjacent to carbonyl/sulfonyl/aromatic pi
            if any(mol.bonds[bi].order >= 2 for _, bi in mol.neighbors(i)):
                continue
            if any(
                _is_carbonyl_carbon(mol, nb) or mol.atoms[nb].aromatic
                or mol.atoms[nb].symbol in ("S", "P")
                for nb in mol.heavy_neighbors(i)
            ):
                continue
            feats.append(("PosIonizable", (i,)))

    # ---- NegIonizable: COOH/COO-, sulfon/phosphon-ic acids, tetrazole
    for i, a in enumerate(mol.atoms):
        if a.symbol == "C" and not a.aromatic:
            os_dbl = [
                nb for nb, bi in mol.neighbors(i)
                if mol.atoms[nb].symbol == "O" and mol.bonds[bi].order == 2
            ]
            os_sgl = [
                nb for nb, bi in mol.neighbors(i)
                if mol.atoms[nb].symbol == "O" and mol.bonds[bi].order == 1
                and (mol.total_h(nb) > 0 or mol.atoms[nb].charge < 0)
            ]
            if os_dbl and os_sgl:
                feats.append(
                    ("NegIonizable", tuple(sorted([i] + os_dbl + os_sgl)))
                )
        if a.symbol in ("S", "P"):
            os_all = [
                nb for nb in mol.heavy_neighbors(i)
                if mol.atoms[nb].symbol == "O"
            ]
            acidic = [
                nb for nb in os_all
                if mol.total_h(nb) > 0 or mol.atoms[nb].charge < 0
            ]
            if len(os_all) >= 3 and acidic:
                feats.append(("NegIonizable", tuple(sorted([i] + os_all))))
    # tetrazole rings (4 N + 1 C aromatic 5-ring)
    for r in arings:
        if len(r) == 5:
            syms = sorted(mol.atoms[i].symbol for i in r)
            if syms == ["C", "N", "N", "N", "N"]:
                feats.append(("NegIonizable", tuple(sorted(r))))

    # ---- Hydrophobe: halogens on C; maximal acyclic all-carbon clusters
    for i, a in enumerate(mol.atoms):
        if a.symbol in ("Cl", "Br", "I") or (
            a.symbol == "F"
            and any(
                sum(
                    mol.atoms[x].symbol == "F"
                    for x in mol.heavy_neighbors(nb)
                ) >= 3
                for nb in mol.heavy_neighbors(i)
            )
        ):
            feats.append(("Hydrophobe", (i,)))

    def carbon_like(i: int) -> bool:
        a = mol.atoms[i]
        return (
            a.symbol == "C"
            and not a.aromatic
            and not in_ring[i]
            and all(s in ("C",) for s in _neighbor_symbols(mol, i))
        )

    seen = set()
    for i in range(n):
        if i in seen or not carbon_like(i):
            continue
        group = []
        stack = [i]
        while stack:
            cur = stack.pop()
            if cur in seen or not carbon_like(cur):
                continue
            seen.add(cur)
            group.append(cur)
            stack.extend(mol.heavy_neighbors(cur))
        if 1 <= len(group) <= 4:
            feats.append(("Hydrophobe", tuple(sorted(group))))

    # ---- LumpedHydrophobe: all-carbon rings
    for r in rings:
        if all(mol.atoms[i].symbol == "C" for i in r):
            feats.append(("LumpedHydrophobe", tuple(sorted(r))))

    # dedupe
    out = []
    seen_f = set()
    for f in feats:
        if f not in seen_f:
            seen_f.add(f)
            out.append(f)
    return out


def features_to_gcpg_indices(feats: List[Feature]) -> List[Tuple[int, Tuple[int, ...]]]:
    """(family, atoms) -> (1-based GCPG index, atoms); unknown -> 7."""
    return [(GCPG_MAPPING.get(fam, 7), atoms) for fam, atoms in feats]
