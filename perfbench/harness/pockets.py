"""Synthetic pockets from a seed, the benchmark's own copies of the port's
``realistic_ca_pocket`` and ``full_atom_pocket_pdb``, so that later changes
to the program's generators do not move the yardstick.

Each generator returns (coordinates [N, 3] float32, one-hot classes [N, F]
float32), as ``pipeline.sample_phars.pocket_point_cloud`` hands them to the
sampler. A traffic file names its generator under ``pocket.kind``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

Pocket = Tuple[np.ndarray, np.ndarray]

# crossdock_full's atom encoder (C, N, O, S, ...; 11 classes)
FULL_ATOM_CLASSES = {"C": 0, "N": 1, "O": 2, "S": 3}
FULL_ATOM_NF = 11
# preprocessing keeps the residues with an atom within 8 A of the ligand
POCKET_CUTOFF = 8.0
SIDE_CHAINS = {
    "ALA": ("CB",), "ARG": ("CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"),
    "ASN": ("CB", "CG", "OD1", "ND2"), "ASP": ("CB", "CG", "OD1", "OD2"),
    "CYS": ("CB", "SG"), "GLN": ("CB", "CG", "CD", "OE1", "NE2"),
    "GLU": ("CB", "CG", "CD", "OE1", "OE2"), "GLY": (),
    "HIS": ("CB", "CG", "ND1", "CD2", "CE1", "NE2"), "ILE": ("CB", "CG1", "CG2", "CD1"),
    "LEU": ("CB", "CG", "CD1", "CD2"), "LYS": ("CB", "CG", "CD", "CE", "NZ"),
    "MET": ("CB", "CG", "SD", "CE"), "PHE": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "PRO": ("CB", "CG", "CD"), "SER": ("CB", "OG"), "THR": ("CB", "OG1", "CG2"),
    "TRP": ("CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
    "TYR": ("CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
    "VAL": ("CB", "CG1", "CG2"),
}


def ca_shell(rng: np.random.RandomState, n: int, r_lo: float = 8.0, r_hi: float = 14.0,
             min_sep: float = 3.8) -> np.ndarray:
    """n CA positions in a shell around the binding site, at least min_sep
    apart: folded-protein density (one CA per ~85 A^3), so a 6 A cutoff
    sees a real pocket's edge density. [n, 3] float32."""
    pts: list = []
    while len(pts) < n:
        v = rng.randn(3)
        v /= np.linalg.norm(v) + 1e-9
        p = v * (r_lo ** 3 + rng.rand() * (r_hi ** 3 - r_lo ** 3)) ** (1 / 3)
        if pts and np.min(np.linalg.norm(np.array(pts) - p, axis=1)) < min_sep:
            continue
        pts.append(p)
    return np.array(pts, dtype=np.float32)


def ca_pocket(rng: np.random.RandomState, atoms: int, classes: int = 20) -> Pocket:
    """A CA pocket of ``atoms`` residues of uniform random types."""
    x = ca_shell(rng, atoms)
    return x, np.eye(classes, dtype=np.float32)[rng.randint(0, classes, atoms)]


def _unit(rng: np.random.RandomState) -> np.ndarray:
    v = rng.randn(3)
    return v / (np.linalg.norm(v) + 1e-9)


def full_atom_pocket(rng: np.random.RandomState, atoms: int, residues: int = 120,
                     ligand_atoms: int = 24) -> Pocket:
    """A full-atom pocket of exactly ``atoms`` heavy atoms around a ligand
    of ``ligand_atoms`` carbons within 4.5 A of the origin (the ligand is
    not a node).

    Residues of random types, their CAs 4.5-13 A around the ligand's
    centroid, each with its backbone N, CA, C, O and its side chain's heavy
    atoms stepping from the CA toward the nearest ligand atom, stopping
    3.5 A short of it; residues with an atom within 8 A of the ligand are
    kept, nearest first, and the last one kept is cut to its atoms nearest
    the CA so that the count is exact. Raises where ``residues`` give too
    few atoms."""
    lig = rng.randn(ligand_atoms, 3)
    lig *= 4.5 * rng.rand(ligand_atoms, 1) ** (1 / 3) / np.linalg.norm(lig, axis=1,
                                                                       keepdims=True)
    names = list(SIDE_CHAINS)
    ca = ca_shell(rng, residues, r_lo=4.5, r_hi=13.0, min_sep=3.4).astype(np.float64)
    ca += lig.mean(0)
    kept = []
    for p in ca:
        res = names[rng.randint(len(names))]
        d = np.linalg.norm(lig - p, axis=1)
        u = (lig[d.argmin()] - p) / max(d.min(), 1e-6)
        side = SIDE_CHAINS[res]
        reach = np.clip(d.min() - 3.5, 1.5, 1.5 * max(len(side), 1))
        c = p + 1.52 * _unit(rng)
        group = [("N", p + 1.46 * _unit(rng)), ("CA", p), ("C", c),
                 ("O", c + 1.23 * _unit(rng))]
        group += [(a, p + u * reach * (k + 1) / len(side) + 0.4 * rng.randn(3))
                  for k, a in enumerate(side)]
        xyz = np.stack([v for _, v in group])
        near = np.linalg.norm(xyz[:, None] - lig[None], axis=-1).min()
        if near < POCKET_CUTOFF:
            kept.append((near, group))
    kept.sort(key=lambda r: r[0])
    group_atoms = [a for _, group in kept for a in group]
    if len(group_atoms) < atoms:
        raise ValueError(f"{residues} residues give {len(group_atoms)} pocket atoms, "
                         f"fewer than {atoms}")
    group_atoms = group_atoms[:atoms]
    x = np.stack([v for _, v in group_atoms]).astype(np.float32)
    onehot = np.zeros((atoms, FULL_ATOM_NF), np.float32)
    onehot[np.arange(atoms), [FULL_ATOM_CLASSES[name[0]] for name, _ in group_atoms]] = 1.0
    return x, onehot


GENERATORS: Dict[str, Callable[..., Pocket]] = {
    "ca": ca_pocket,
    "full_atom": full_atom_pocket,
}


def make_pocket(spec: dict, rng: np.random.RandomState) -> Pocket:
    """The pocket a traffic file's ``pocket`` group asks for: ``kind`` names
    the generator, the other keys are its arguments."""
    args = {k: v for k, v in spec.items() if k != "kind"}
    if spec["kind"] not in GENERATORS:
        raise ValueError(f"unknown pocket kind {spec['kind']!r}; known: {sorted(GENERATORS)}")
    return GENERATORS[spec["kind"]](rng, **args)
