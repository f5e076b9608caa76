"""SDF (MDL molfile V2000) reading/writing with 3-D coordinates.

Replaces the reference's RDKit SDMolSupplier/SDWriter usage at the
preprocessing and alignment boundaries (process_crossdock.py:259-265,
PharAlign SDF outputs). Only what the pipeline needs: atoms, 3-D coords,
bonds with orders (type 4 = aromatic), charges (M  CHG).

A copy of ``cmdgen_tpu/chem/sdf.py``; the header line names the JAX
package's program, so both packages write the same bytes.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from cmdgen_tpu_torch.chem.mol import Atom, Mol


def parse_sdf_block(block: str) -> Tuple[Optional[Mol], Optional[np.ndarray]]:
    """One molfile block -> (Mol, coords [N,3]); (None, None) on failure."""
    lines = block.splitlines()
    if len(lines) < 4:
        return None, None
    counts = lines[3]
    try:
        n_atoms = int(counts[0:3])
        n_bonds = int(counts[3:6])
    except ValueError:
        return None, None
    mol = Mol()
    coords = np.zeros((n_atoms, 3), dtype=np.float32)
    try:
        for i in range(n_atoms):
            ln = lines[4 + i]
            coords[i] = [float(ln[0:10]), float(ln[10:20]), float(ln[20:30])]
            sym = ln[31:34].strip()
            mol.add_atom(Atom(sym))
        aromatic_atoms = set()
        for i in range(n_bonds):
            ln = lines[4 + n_atoms + i]
            a1, a2 = int(ln[0:3]) - 1, int(ln[3:6]) - 1
            btype = int(ln[6:9])
            if btype == 4:
                mol.add_bond(a1, a2, 1, aromatic=True)
                aromatic_atoms.update((a1, a2))
            else:
                mol.add_bond(a1, a2, min(btype, 3))
        for a in aromatic_atoms:
            mol.atoms[a].aromatic = True
        # properties
        for ln in lines[4 + n_atoms + n_bonds :]:
            if ln.startswith("M  CHG"):
                parts = ln.split()
                n = int(parts[2])
                for k in range(n):
                    idx = int(parts[3 + 2 * k]) - 1
                    mol.atoms[idx].charge = int(parts[4 + 2 * k])
            elif ln.startswith("M  END"):
                break
    except (ValueError, IndexError):
        return None, None
    if any(a.aromatic for a in mol.atoms):
        if not mol.kekulize():
            return None, None
    return mol, coords


def read_sdf(path) -> List[Tuple[Mol, np.ndarray]]:
    """All molecules of an SDF file (with their conformer coordinates)."""
    text = Path(path).read_text()
    out = []
    for block in text.split("$$$$"):
        block = block.strip("\n")
        if not block.strip():
            continue
        mol, coords = parse_sdf_block(block)
        if mol is not None:
            out.append((mol, coords))
    return out


def heavy_atom_view(mol: Mol, coords: np.ndarray):
    """(symbols, coords) of non-hydrogen atoms."""
    idx = [i for i, a in enumerate(mol.atoms) if a.symbol != "H"]
    return [mol.atoms[i].symbol for i in idx], coords[idx]


def write_sdf_block(
    symbols: List[str], coords: np.ndarray, name: str = "", bonds=None
) -> str:
    """Minimal V2000 writer (bonds: [(a1, a2, order)] 0-based)."""
    bonds = bonds or []
    lines = [name, "  cmdgen_tpu", "", ""]
    lines[3] = (
        f"{len(symbols):>3}{len(bonds):>3}  0  0  0  0  0  0  0  0999 V2000"
    )
    for s, (x, y, z) in zip(symbols, np.asarray(coords)):
        lines.append(
            f"{x:10.4f}{y:10.4f}{z:10.4f} {s:<3} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for a1, a2, order in bonds:
        lines.append(f"{a1 + 1:>3}{a2 + 1:>3}{order:>3}  0  0  0  0")
    lines.append("M  END")
    return "\n".join(lines)


def write_sdf(path, mols: List[Tuple[List[str], np.ndarray, str]], bonds_list=None):
    """Write multiple conformers: [(symbols, coords, name)]."""
    blocks = []
    for i, (symbols, coords, name) in enumerate(mols):
        bonds = bonds_list[i] if bonds_list else None
        blocks.append(write_sdf_block(symbols, coords, name, bonds))
    Path(path).write_text("\n$$$$\n".join(blocks) + "\n$$$$\n")
