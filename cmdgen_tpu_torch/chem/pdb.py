"""Minimal PDB parsing and pocket extraction (a copy of
``cmdgen_tpu/chem/pdb.py``).

Replaces the reference's BioPython usage (DiffPhar/lightning_modules.py:
411-420, utils.py:102-119, process_crossdock.py:54-152): parse ATOM/HETATM
records from fixed columns, group into residues, and extract the binding
pocket either from an explicit residue list or as all residues with any
atom within a cutoff of a reference ligand.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cmdgen_tpu_torch.chem.constants import AA_3TO1, DATASET_PARAMS


@dataclasses.dataclass
class PDBAtom:
    name: str
    element: str
    x: float
    y: float
    z: float
    chain: str
    res_name: str
    res_id: int
    is_hetatm: bool

    @property
    def coord(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], dtype=np.float32)


@dataclasses.dataclass
class Residue:
    chain: str
    res_id: int
    res_name: str
    atoms: List[PDBAtom]

    @property
    def key(self) -> str:
        return f"{self.chain}:{self.res_id}"

    def ca(self) -> Optional[PDBAtom]:
        for a in self.atoms:
            if a.name == "CA":
                return a
        return None

    def coords(self, heavy_only: bool = True) -> np.ndarray:
        atoms = [
            a for a in self.atoms if not (heavy_only and a.element == "H")
        ]
        return np.stack([a.coord for a in atoms]) if atoms else np.zeros((0, 3))


def parse_pdb(path_or_text) -> List[Residue]:
    """Parse ATOM + HETATM records into residues, first model only."""
    if isinstance(path_or_text, (str, Path)) and "\n" not in str(path_or_text):
        text = Path(path_or_text).read_text()
    else:
        text = str(path_or_text)
    residues: Dict[Tuple[str, int, str], Residue] = {}
    for line in text.splitlines():
        rec = line[:6].strip()
        if rec == "ENDMDL":
            break
        if rec not in ("ATOM", "HETATM"):
            continue
        altloc = line[16].strip()
        if altloc not in ("", "A"):
            continue
        name = line[12:16].strip()
        res_name = line[17:20].strip()
        chain = line[21].strip() or "_"
        try:
            res_id = int(line[22:26])
            x, y, z = float(line[30:38]), float(line[38:46]), float(line[46:54])
        except ValueError:
            continue
        element = line[76:78].strip().capitalize()
        if not element:
            element = "".join(c for c in name if c.isalpha())[:1]
        atom = PDBAtom(
            name, element, x, y, z, chain, res_name, res_id, rec == "HETATM"
        )
        key = (chain, res_id, res_name)
        if key not in residues:
            residues[key] = Residue(chain, res_id, res_name, [])
        residues[key].atoms.append(atom)
    return list(residues.values())


def protein_residues(residues: Sequence[Residue]) -> List[Residue]:
    return [r for r in residues if r.res_name in AA_3TO1]


def ligand_atoms(
    residues: Sequence[Residue], ref_ligand: str
) -> List[PDBAtom]:
    """'chain:resid' selector for the reference ligand
    (generate_phars.py --ref_ligand, lightning_modules.py:417-419)."""
    chain, res_id = ref_ligand.split(":")
    out = []
    for r in residues:
        if r.chain == chain and r.res_id == int(res_id):
            out.extend(a for a in r.atoms if a.element != "H")
    if not out:
        raise ValueError(f"reference ligand {ref_ligand} not found")
    return out


def pocket_from_ligand(
    residues: Sequence[Residue],
    ligand_coords: np.ndarray,
    cutoff: float = 8.0,
) -> List[Residue]:
    """Residues with any heavy atom within cutoff Å of the ligand
    (utils.py:102-119 / process_crossdock.py:67-75)."""
    out = []
    for r in protein_residues(residues):
        c = r.coords()
        if len(c) == 0:
            continue
        d = np.sqrt(
            ((c[:, None, :] - ligand_coords[None, :, :]) ** 2).sum(-1)
        )
        if (d < cutoff).any():
            out.append(r)
    return out


def pocket_by_ids(
    residues: Sequence[Residue], resi_list: Sequence[str]
) -> List[Residue]:
    """Explicit 'chain:resid' pocket list (lightning_modules.py:411-416)."""
    wanted = set(resi_list)
    return [r for r in protein_residues(residues) if r.key in wanted]


def featurize_pocket(
    pocket: Sequence[Residue], representation: str, dataset: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Pocket residues -> (coords [N,3], one_hot [N,F]).

    representation 'full-atom': one node per heavy atom, element classes;
    'CA': one node per residue at the C-alpha, amino-acid classes
    (process_crossdock.py:111-152).
    """
    params = DATASET_PARAMS[dataset]
    if representation == "full-atom":
        enc = params["atom_encoder"]
        nf = len(set(enc.values()))
        coords, onehot = [], []
        for r in pocket:
            for a in r.atoms:
                if a.element == "H":
                    continue
                coords.append(a.coord)
                idx = enc.get(a.element, enc.get("others"))
                if idx is None:
                    continue
                v = np.zeros(nf, dtype=np.float32)
                v[idx] = 1.0
                onehot.append(v)
        return np.stack(coords), np.stack(onehot)
    elif representation == "CA":
        enc = params["aa_encoder"]
        nf = len(set(enc.values()))
        coords, onehot = [], []
        for r in pocket:
            ca = r.ca()
            if ca is None:
                continue
            one = AA_3TO1.get(r.res_name)
            if one is None or one not in enc:
                continue
            coords.append(ca.coord)
            v = np.zeros(nf, dtype=np.float32)
            v[enc[one]] = 1.0
            onehot.append(v)
        return np.stack(coords), np.stack(onehot)
    raise ValueError(representation)
