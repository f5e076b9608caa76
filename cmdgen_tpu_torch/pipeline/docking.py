"""Docking adapters: qvina2 / smina subprocess wrappers + PDBQT prep.

Behavioral equivalent of DiffPhar/analysis/docking.py:12-148 plus the prep
chain the reference shells out for: ligand SDF->PDBQT with Gasteiger
charges and a rotatable-branch torsion tree (obabel, docking.py:21-24) and
receptor PDB->PDBQT (MGLTools ``prepare_receptor4.py``,
docking_py27.py:6-25). Neither those binaries nor OpenBabel are assumed
installed, so both preps are implemented natively: PEOE charges from
``chem.gasteiger``, AutoDock-style rotatable-bond detection + nested
BRANCH tree, polar-hydrogen placement, and name-table receptor typing over
``chem.pdb`` residues. Binaries remain gated on availability
(``docking_available``).

A copy of ``cmdgen_tpu/pipeline/docking.py`` on the port's chem modules:
the binaries are found on ``PATH`` and ``docking_available()`` is the gate,
as there.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmdgen_tpu_torch.chem.mol import Mol


def find_binary(*names: str) -> Optional[str]:
    for n in names:
        p = shutil.which(n)
        if p:
            return p
    return None


def docking_available() -> bool:
    return find_binary("qvina2.1", "qvina2", "qvina") is not None or (
        find_binary("smina", "smina.static") is not None
    )


def _ad4_type(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    s = a.symbol
    if s == "C":
        return "A" if a.aromatic else "C"
    if s == "N":
        # N with no H = acceptor NA
        return "NA" if mol.total_h(i) == 0 else "N"
    if s == "O":
        return "OA"
    if s == "S":
        return "SA"
    if s == "H":
        return "HD"
    return s


def rotatable_bonds(mol: Mol) -> List[int]:
    """AutoDock-style active torsions: acyclic single non-aromatic bonds
    that move at least one heavy atom on each side, excluding amide C-N
    (prepare_ligand4 / obabel rotor rules — the bonds obabel emits as
    BRANCH records in the reference's prep, docking.py:21-24)."""
    ring = mol.ring_bond_flags()
    out = []
    for bi, b in enumerate(mol.bonds):
        # in-ring bonds (incl. all truly aromatic ones) are rigid; an
        # acyclic bond flagged aromatic by the parser (biphenyl pivot,
        # written between two lowercase atoms) is still a rotor
        if b.order != 1 or ring[bi]:
            continue
        if len(mol.heavy_neighbors(b.a1)) < 2 or len(mol.heavy_neighbors(b.a2)) < 2:
            continue  # terminal: rotates only hydrogens
        # amide: N single-bonded to a carbonyl carbon
        def _amide(n, c):
            return (
                mol.atoms[n].symbol == "N"
                and mol.atoms[c].symbol == "C"
                and any(
                    mol.bonds[b2].order == 2
                    and mol.atoms[nb].symbol in ("O", "S")
                    for nb, b2 in mol.neighbors(c)
                )
            )
        if _amide(b.a1, b.a2) or _amide(b.a2, b.a1):
            continue
        out.append(bi)
    return out


def place_polar_hydrogens(
    mol: Mol, coords: np.ndarray
) -> List[Tuple[int, np.ndarray]]:
    """Geometric positions for the implicit hydrogens on N/O/S atoms (the
    HD atoms a PDBQT keeps). Each H sits at the standard bond length along
    the direction that completes the parent's coordination: opposite the
    mean of the existing bond vectors, fanned for multiple hydrogens."""
    out = []
    blen = {"N": 1.01, "O": 0.96, "S": 1.34}
    for i, a in enumerate(mol.atoms):
        if a.symbol not in blen:
            continue
        n_h = mol.total_h(i)
        if n_h == 0:
            continue
        nbrs = mol.heavy_neighbors(i)
        vecs = [coords[j] - coords[i] for j in nbrs]
        if vecs:
            base = -np.sum(
                [v / (np.linalg.norm(v) + 1e-12) for v in vecs], axis=0
            )
            if np.linalg.norm(base) < 1e-6:
                base = np.array([0.0, 0.0, 1.0])
        else:
            base = np.array([0.0, 0.0, 1.0])
        base = base / np.linalg.norm(base)
        # orthonormal fan plane for >1 H
        ref = np.array([1.0, 0.0, 0.0])
        if abs(np.dot(ref, base)) > 0.9:
            ref = np.array([0.0, 1.0, 0.0])
        perp = np.cross(base, ref)
        perp /= np.linalg.norm(perp)
        for k in range(n_h):
            if n_h == 1:
                d = base
            else:
                ang = (k - (n_h - 1) / 2.0) * (np.pi / 3.2)
                d = np.cos(ang) * base + np.sin(ang) * perp
                d = d / np.linalg.norm(d)
            out.append((i, coords[i] + d * blen[a.symbol]))
    return out


def _pdbqt_atom_line(
    serial: int, aname: str, resname: str, chain: str, resseq: int,
    xyz, charge: float, ad4: str,
) -> str:
    x, y, z = (float(v) for v in xyz)
    # standard PDB fixed columns: serial 7-11, name 13-16, resName 18-20,
    # chain 22, resSeq 23-26, x/y/z 31-54, then the PDBQT charge + AD4 type
    return (
        f"ATOM  {serial:>5} {aname:<4} {resname:<3} {chain:1}{resseq:>4}    "
        f"{x:8.3f}{y:8.3f}{z:8.3f}{1.00:6.2f}{0.00:6.2f}    "
        f"{charge:6.3f} {ad4:<2}"
    )


def write_pdbqt(
    path, mol: Mol, coords: np.ndarray, name: str = "LIG",
    flexible: bool = True, add_polar_h: bool = True,
):
    """Ligand PDBQT writer with Gasteiger charges, polar hydrogens, and a
    nested rotatable-branch torsion tree — the structure obabel produces
    for the reference (docking.py:21-24). ``flexible=False`` reproduces the
    old rigid single-ROOT output (score-only use)."""
    from cmdgen_tpu_torch.chem.gasteiger import heavy_charges_ad4

    coords = np.asarray(coords, dtype=np.float64)
    charges, h_charges = heavy_charges_ad4(mol)
    polar_h = place_polar_hydrogens(mol, coords) if add_polar_h else []
    # group the placed hydrogens (in order) per parent atom
    h_pos: Dict[int, List[np.ndarray]] = {}
    for i, pos in polar_h:
        h_pos.setdefault(i, []).append(pos)

    rot = rotatable_bonds(mol) if flexible else []
    rot_set = set(rot)
    n = mol.n_atoms

    # rigid fragments = connected components after cutting active torsions
    frag_of = [-1] * n
    frags: List[List[int]] = []
    for s in range(n):
        if frag_of[s] >= 0:
            continue
        comp = [s]
        frag_of[s] = len(frags)
        stack = [s]
        while stack:
            cur = stack.pop()
            for nb, bi in mol.neighbors(cur):
                if bi in rot_set or frag_of[nb] >= 0:
                    continue
                frag_of[nb] = len(frags)
                comp.append(nb)
                stack.append(nb)
        frags.append(sorted(comp))

    # fragment adjacency via the rotatable bonds
    fadj: Dict[int, List[Tuple[int, int, int]]] = {}  # frag -> (frag2, a, b)
    for bi in rot:
        b = mol.bonds[bi]
        f1, f2 = frag_of[b.a1], frag_of[b.a2]
        fadj.setdefault(f1, []).append((f2, b.a1, b.a2))
        fadj.setdefault(f2, []).append((f1, b.a2, b.a1))

    def subtree_size(root: int, parent: int) -> int:
        tot = len(frags[root])
        for f2, _, _ in fadj.get(root, []):
            if f2 != parent:
                tot += subtree_size(f2, root)
        return tot

    # root choice: fragment minimizing its largest branch subtree
    # (prepare_ligand4's "best root" heuristic)
    def worst_branch(f: int) -> int:
        return max(
            [subtree_size(f2, f) for f2, _, _ in fadj.get(f, [])],
            default=0,
        )

    root = min(range(len(frags)), key=lambda f: (worst_branch(f), f))

    lines: List[str] = []
    serial_of: Dict[int, int] = {}
    serial = [0]

    def emit_atom(i: int) -> None:
        serial[0] += 1
        serial_of[i] = serial[0]
        lines.append(_pdbqt_atom_line(
            serial[0], mol.atoms[i].symbol, name, "A", 1,
            coords[i], charges[i], _ad4_type(mol, i),
        ))
        for k, pos in enumerate(h_pos.get(i, [])):
            serial[0] += 1
            hq = h_charges[i][k] if k < len(h_charges[i]) else 0.0
            lines.append(_pdbqt_atom_line(
                serial[0], "H", name, "A", 1, pos, hq, "HD",
            ))

    def emit_fragment(f: int, parent: int, head: Optional[int]) -> None:
        # the child-side bond atom is emitted first so the BRANCH record's
        # second serial (assigned before recursing) is correct
        order = frags[f] if head is None else (
            [head] + [i for i in frags[f] if i != head]
        )
        for i in order:
            emit_atom(i)
        for f2, a, b in sorted(fadj.get(f, [])):
            if f2 == parent:
                continue
            lines.append(f"BRANCH {serial_of[a]:>3} {serial[0] + 1:>3}")
            mark = len(lines) - 1
            emit_fragment(f2, f, b)
            sb = lines[mark].split()
            lines.append(f"ENDBRANCH {sb[1]:>3} {sb[2]:>3}")

    lines.append("ROOT")
    for i in frags[root]:
        emit_atom(i)
    lines.append("ENDROOT")
    for f2, a, b in sorted(fadj.get(root, [])):
        lines.append(f"BRANCH {serial_of[a]:>3} {serial[0] + 1:>3}")
        mark = len(lines) - 1
        emit_fragment(f2, root, b)
        sb = lines[mark].split()
        lines.append(f"ENDBRANCH {sb[1]:>3} {sb[2]:>3}")
    lines.append(f"TORSDOF {len(rot)}")
    Path(path).write_text("\n".join(lines) + "\n")


# ------------------------------------------------------------------ receptor
# name-table chemistry for standard residues: hydrogen counts, aromatic
# atoms, carbonyl/guanidinium double bonds, and ionization at pH ~7 — the
# knowledge MGLTools' prepare_receptor4.py applies before its Gasteiger
# pass (docking_py27.py:6-25). Backbone: N:1 (PRO 0), CA:1 (GLY 2), C:0, O:0.
_SIDECHAIN_H: Dict[str, Dict[str, int]] = {
    "ALA": {"CB": 3},
    "ARG": {"CB": 2, "CG": 2, "CD": 2, "NE": 1, "NH1": 2, "NH2": 2},
    "ASN": {"CB": 2, "ND2": 2},
    "ASP": {"CB": 2},
    "CYS": {"CB": 2, "SG": 1},
    "GLN": {"CB": 2, "CG": 2, "NE2": 2},
    "GLU": {"CB": 2, "CG": 2},
    "GLY": {},
    "HIS": {"CB": 2, "CD2": 1, "CE1": 1, "ND1": 1},
    "ILE": {"CB": 1, "CG1": 2, "CG2": 3, "CD1": 3},
    "LEU": {"CB": 2, "CG": 1, "CD1": 3, "CD2": 3},
    "LYS": {"CB": 2, "CG": 2, "CD": 2, "CE": 2, "NZ": 3},
    "MET": {"CB": 2, "CG": 2, "CE": 3},
    "PHE": {"CB": 2, "CD1": 1, "CD2": 1, "CE1": 1, "CE2": 1, "CZ": 1},
    "PRO": {"CB": 2, "CG": 2, "CD": 2},
    "SER": {"CB": 2, "OG": 1},
    "THR": {"CB": 1, "OG1": 1, "CG2": 3},
    "TRP": {"CB": 2, "CD1": 1, "NE1": 1, "CE3": 1, "CZ2": 1, "CZ3": 1,
            "CH2": 1},
    "TYR": {"CB": 2, "CD1": 1, "CD2": 1, "CE1": 1, "CE2": 1, "OH": 1},
    "VAL": {"CB": 1, "CG1": 3, "CG2": 3},
}
_AROMATIC_ATOMS: Dict[str, set] = {
    "PHE": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
    "TYR": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
    "TRP": {"CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"},
    "HIS": {"CG", "ND1", "CD2", "CE1", "NE2"},
}
_DOUBLE_PAIRS: Dict[str, List[Tuple[str, str]]] = {
    "*": [("C", "O")],
    "ASP": [("CG", "OD1")],
    "GLU": [("CD", "OE1")],
    "ASN": [("CG", "OD1")],
    "GLN": [("CD", "OE1")],
    "ARG": [("CZ", "NH2")],
}
_FORMAL_CHARGES: Dict[Tuple[str, str], int] = {
    ("LYS", "NZ"): 1, ("ARG", "NH2"): 1,
    ("ASP", "OD2"): -1, ("GLU", "OE2"): -1,
    ("*", "OXT"): -1,
}


def receptor_mol_from_pdb(pdb_path_or_text):
    """Protein heavy atoms -> (Mol with explicit_h/aromatic/charges set,
    coords [n,3], per-atom (res_name, atom_name, chain, res_id)).

    Bonds come from the covalent-radius ConnectTheDots pass
    (chem/mol_build.py) — peptide and disulfide bonds emerge naturally —
    then known carbonyl/guanidinium pairs are promoted to order 2 and
    ring-system atoms flagged aromatic so the Gasteiger hybridization keys
    are right."""
    from cmdgen_tpu_torch.chem.mol import Atom
    from cmdgen_tpu_torch.chem.mol_build import connect_the_dots
    from cmdgen_tpu_torch.chem.pdb import parse_pdb, protein_residues

    residues = protein_residues(parse_pdb(pdb_path_or_text))
    atoms_meta: List[Tuple[str, str, str, int]] = []
    coords: List[np.ndarray] = []
    mol = Mol()
    index_of: Dict[Tuple[str, int, str], int] = {}
    for r in residues:
        seen = set()
        for a in r.atoms:
            if a.element == "H" or a.name in seen:
                continue
            seen.add(a.name)
            h_table = _SIDECHAIN_H.get(r.res_name, {})
            if a.name == "N":
                n_h = 0 if r.res_name == "PRO" else 1
            elif a.name == "CA":
                n_h = 2 if r.res_name == "GLY" else 1
            elif a.name in ("C", "O", "OXT"):
                n_h = 0
            else:
                n_h = h_table.get(a.name, 0)
            charge = _FORMAL_CHARGES.get(
                (r.res_name, a.name), _FORMAL_CHARGES.get(("*", a.name), 0)
            )
            atom = Atom(symbol=a.element if a.element else "C")
            atom.explicit_h = n_h
            atom.charge = charge
            atom.aromatic = a.name in _AROMATIC_ATOMS.get(r.res_name, set())
            idx = mol.add_atom(atom)
            index_of[(r.chain, r.res_id, a.name)] = idx
            atoms_meta.append((r.res_name, a.name, r.chain, r.res_id))
            coords.append(a.coord.astype(np.float64))
    xyz = np.asarray(coords)
    for i, j, _d in connect_the_dots([a.symbol for a in mol.atoms], xyz):
        mol.add_bond(i, j, 1)
    # promote known double bonds (hybridization only — explicit_h is set)
    for bi, b in enumerate(mol.bonds):
        rn1, an1, ch1, ri1 = atoms_meta[b.a1]
        rn2, an2, ch2, ri2 = atoms_meta[b.a2]
        if (ch1, ri1) != (ch2, ri2):
            continue
        pairs = _DOUBLE_PAIRS.get("*", []) + _DOUBLE_PAIRS.get(rn1, [])
        if (an1, an2) in pairs or (an2, an1) in pairs:
            b.order = 2
    # disulfide SG-SG: cystine sulfurs carry no H
    for i, (rn, an, _c, _r) in enumerate(atoms_meta):
        if an == "SG" and len(mol.heavy_neighbors(i)) >= 2:
            mol.atoms[i].explicit_h = 0
    return mol, xyz, atoms_meta


def _ad4_receptor_type(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    if a.symbol == "C":
        return "A" if a.aromatic else "C"
    if a.symbol == "N":
        return "NA" if mol.total_h(i) == 0 else "N"
    if a.symbol == "O":
        return "OA"
    if a.symbol == "S":
        return "SA"
    return a.symbol


def prepare_receptor_pdbqt(pdb_path_or_text, out_path) -> Path:
    """Receptor PDB -> PDBQT: the behavioral equivalent of MGLTools'
    ``prepare_receptor4.py`` as the reference calls it for CrossDocked
    (docking_py27.py:14-16 — no -A flag, so hydrogens are NOT added; heavy
    atoms carry Gasteiger charges computed with implicit-H expansion and
    AD4 atom types)."""
    from cmdgen_tpu_torch.chem.gasteiger import gasteiger_charges

    mol, xyz, meta = receptor_mol_from_pdb(pdb_path_or_text)
    heavy, h_charges = gasteiger_charges(mol)
    # united-atom receptor: every implicit H's charge merges into its heavy
    # atom (prepare_receptor4's default -U nphs merges non-polar H; with no
    # H in the input PDB, ALL H charge mass sits on the heavy atoms)
    lines = []
    for i, (rn, an, ch, ri) in enumerate(meta):
        q = heavy[i] + sum(h_charges[i])
        lines.append(_pdbqt_atom_line(
            i + 1, an, rn, ch, ri, xyz[i], q, _ad4_receptor_type(mol, i),
        ))
    out_path = Path(out_path)
    out_path.write_text("\n".join(lines) + "\n")
    return out_path


def smina_score_only(
    receptor_pdbqt, ligand_pdbqt, binary: Optional[str] = None
) -> Optional[float]:
    """``smina --score_only`` affinity (docking.py:12-18)."""
    binary = binary or find_binary("smina", "smina.static")
    if binary is None:
        raise RuntimeError("smina binary not available")
    out = subprocess.run(
        [binary, "--score_only", "-r", str(receptor_pdbqt),
         "-l", str(ligand_pdbqt)],
        capture_output=True, text=True, timeout=300,
    )
    m = re.search(r"Affinity:\s*([\-0-9.]+)", out.stdout)
    return float(m.group(1)) if m else None


def qvina_dock(
    receptor_pdbqt,
    ligand_pdbqt,
    center: Sequence[float],
    out_path,
    size: float = 20.0,
    exhaustiveness: int = 16,
    binary: Optional[str] = None,
) -> Optional[List[float]]:
    """qvina2 docking with the box centered at the ligand CoM
    (docking.py:27-88). Returns the pose scores parsed from stdout."""
    binary = binary or find_binary("qvina2.1", "qvina2", "qvina")
    if binary is None:
        raise RuntimeError("qvina binary not available")
    cx, cy, cz = center
    out = subprocess.run(
        [
            binary, "--receptor", str(receptor_pdbqt),
            "--ligand", str(ligand_pdbqt),
            "--center_x", str(cx), "--center_y", str(cy), "--center_z", str(cz),
            "--size_x", str(size), "--size_y", str(size), "--size_z", str(size),
            "--exhaustiveness", str(exhaustiveness),
            "--out", str(out_path),
        ],
        capture_output=True, text=True, timeout=1800,
    )
    scores = [
        float(m.group(1))
        for m in re.finditer(r"^\s*\d+\s+([\-0-9.]+)\s", out.stdout, re.M)
    ]
    return scores or None


def calculate_qvina2_score(
    receptor_pdbqt, mol: Mol, coords: np.ndarray, workdir,
    score_only: bool = False,
) -> Optional[float]:
    """End-to-end score of one posed molecule (docking.py:27-88). A
    receptor given as .pdb is prepped to PDBQT first, as the reference does
    (docking.py:33-38 -> prepare_receptor4.py)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    receptor_pdbqt = Path(receptor_pdbqt)
    if receptor_pdbqt.suffix == ".pdb":
        receptor_pdbqt = prepare_receptor_pdbqt(
            receptor_pdbqt, workdir / (receptor_pdbqt.stem + ".pdbqt")
        )
    lig = workdir / "ligand.pdbqt"
    write_pdbqt(lig, mol, coords)
    if score_only:
        return smina_score_only(receptor_pdbqt, lig)
    center = coords.mean(axis=0)
    scores = qvina_dock(receptor_pdbqt, lig, center, workdir / "docked.pdbqt")
    return scores[0] if scores else None
