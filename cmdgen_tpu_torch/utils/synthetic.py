"""Synthetic-but-realistic geometry generators for benchmarks and tests
(a copy of ``cmdgen_tpu/utils/synthetic.py``), and writers of the files
the evaluation harnesses and ``preprocess`` read: a DiffPhar test npz of
synthetic complexes, a pose PDB of one ligand and a full-atom pocket PDB
around a ligand."""
from __future__ import annotations

import numpy as np

from cmdgen_tpu_torch.data.crossdocked import POCKET_CUTOFF


def realistic_ca_pocket(rng: np.random.RandomState, n: int,
                        r_lo: float = 8.0, r_hi: float = 14.0,
                        min_sep: float = 3.8) -> np.ndarray:
    """n CA positions in a shell around the binding site, Poisson-disk-ish.

    Matches folded-protein density (one CA per ~85 Å³, CA-CA >= 3.8 Å) so a
    6 Å-cutoff adjacency sees the same ~5% edge density as a real
    CrossDocked pocket; a Gaussian blob is ~7x too dense and defeats
    cutoff-based sparsity. Returns [n, 3] float32.
    """
    pts: list = []
    while len(pts) < n:
        v = rng.randn(3)
        v /= np.linalg.norm(v) + 1e-9
        r = (r_lo**3 + rng.rand() * (r_hi**3 - r_lo**3)) ** (1 / 3)
        p = v * r
        if pts and np.min(np.linalg.norm(np.array(pts) - p, axis=1)) < min_sep:
            continue
        pts.append(p)
    return np.array(pts, dtype=np.float32)


def synthetic_pocket_pdb(rng: np.random.RandomState, n_residues: int = 90,
                         n_ligand_atoms: int = 12) -> str:
    """PDB text of a synthetic CA-only protein pocket around a ligand.

    ``n_residues`` CA atoms from :func:`realistic_ca_pocket` (random amino
    acids, chain A) around a HETATM ligand ``LIG`` at ``L:1`` whose carbon
    atoms lie within 4 Å of the origin. For the CLI's ``--ref-ligand L:1``.
    """
    aas = ["ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
           "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL"]
    ca = realistic_ca_pocket(rng, n_residues, r_lo=4.5, r_hi=14.0)
    lig = rng.randn(n_ligand_atoms, 3)
    lig *= (4.0 * rng.rand(n_ligand_atoms, 1) ** (1 / 3)
            / np.linalg.norm(lig, axis=1, keepdims=True))

    def line(rec, serial, name, resn, chain, resid, xyz, elem):
        return (f"{rec:<6}{serial:>5} {name:<4} {resn:>3} {chain}{resid:>4}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{0.0:6.2f}"
                f"          {elem:>2}")

    rows = [line("ATOM", i + 1, "CA", aas[rng.randint(len(aas))], "A", i + 1, p, "C")
            for i, p in enumerate(ca)]
    rows += [line("HETATM", n_residues + j + 1, f"C{j + 1}", "LIG", "L", 1, p, "C")
             for j, p in enumerate(lig)]
    return "\n".join(rows + ["END"]) + "\n"


def synthetic_diffphar_npz(path, rng: np.random.RandomState, n_complexes: int = 8,
                           n_pocket=(30, 60), n_phar=(3, 8), phar_nf: int = 8,
                           residue_nf: int = 20) -> None:
    """Write a test set in ``DiffPharDataset``'s npz format: per complex a
    ``realistic_ca_pocket`` of n_pocket[0] <= n < n_pocket[1] CA atoms with
    random residue types, and n_phar[0] <= k < n_phar[1] pharmacophore
    points of random families within ~3 Å of its centre, all shifted by a
    random offset. Rows of every complex are concatenated; the ``*_mask``
    arrays hold the complex index of each row."""
    keys = ("phar_coords", "phar_one_hot", "phar_mask",
            "pocket_c_alpha", "pocket_one_hot", "pocket_mask")
    cols = {k: [] for k in keys}
    for i in range(n_complexes):
        nq, k = rng.randint(*n_pocket), rng.randint(*n_phar)
        offset = rng.randn(3) * 10.0
        cols["pocket_c_alpha"].append(realistic_ca_pocket(rng, nq, r_lo=4.5) + offset)
        cols["pocket_one_hot"].append(np.eye(residue_nf)[rng.randint(0, residue_nf, nq)])
        cols["pocket_mask"].append(np.full(nq, i))
        cols["phar_coords"].append(rng.randn(k, 3) * 1.5 + offset)
        cols["phar_one_hot"].append(np.eye(phar_nf)[rng.randint(0, phar_nf, k)])
        cols["phar_mask"].append(np.full(k, i))
    arrays = {k: np.concatenate(v).astype(np.int64 if k.endswith("mask") else np.float32)
              for k, v in cols.items()}
    np.savez(path, names=np.array([f"complex_{i}" for i in range(n_complexes)]), **arrays)


def ligand_pdb(symbols, coords, res_name: str = "LIG", chain: str = "L",
               resid: int = 1) -> str:
    """PDB text of one ligand: an HETATM line per atom (``--ref-ligand
    L:1`` selects it)."""
    rows = []
    for j, (el, xyz) in enumerate(zip(symbols, np.asarray(coords, dtype=np.float64))):
        name = f"{el}{j + 1}"[:4]
        rows.append(f"{'HETATM':<6}{j + 1:>5} {name:<4} {res_name:>3} {chain}{resid:>4}    "
                    f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {el:>2}")
    return "\n".join(rows + ["END"]) + "\n"


# heavy side-chain atoms of each amino acid after the backbone's N, CA, C, O
# (PDB atom names; the element is the name's first letter)
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


def _unit(rng):
    v = rng.randn(3)
    return v / (np.linalg.norm(v) + 1e-9)


def full_atom_pocket_pdb(rng: np.random.RandomState, ligand_symbols, ligand_coords,
                         n_residues: int, max_atoms: int):
    """(PDB text, pocket heavy atoms) of a synthetic full-atom pocket around
    a ligand, whose heavy atoms follow as HETATM ``LIG`` at ``L:1``.

    ``n_residues`` residues of random types (chain A), their CAs from
    :func:`realistic_ca_pocket` 4.5-13 Å around the ligand's centroid; each
    has its backbone N, CA, C and O and its side chain's heavy atoms
    (``SIDE_CHAINS``; elements N, C, O, S) stepping from the CA toward the
    nearest ligand heavy atom, stopping 3.5 Å short of it. Only residues
    with an atom within preprocessing's ``POCKET_CUTOFF`` Å of a ligand
    heavy atom are written, so that rule and ``--ref-ligand L:1`` keep
    every one; the farthest go first until at most ``max_atoms`` pocket
    atoms remain."""
    lig = np.asarray(ligand_coords, dtype=np.float64)
    heavy = lig[[el != "H" for el in ligand_symbols]]
    names = list(SIDE_CHAINS)
    ca = realistic_ca_pocket(rng, n_residues, r_lo=4.5, r_hi=13.0, min_sep=3.4).astype(
        np.float64) + heavy.mean(0)
    residues = []
    for p in ca:
        res = names[rng.randint(len(names))]
        d = np.linalg.norm(heavy - p, axis=1)
        u = (heavy[d.argmin()] - p) / max(d.min(), 1e-6)
        side = SIDE_CHAINS[res]
        reach = np.clip(d.min() - 3.5, 1.5, 1.5 * max(len(side), 1))
        c = p + 1.52 * _unit(rng)
        atoms = [("N", p + 1.46 * _unit(rng)), ("CA", p), ("C", c), ("O", c + 1.23 * _unit(rng))]
        atoms += [(a, p + u * reach * (k + 1) / len(side) + 0.4 * rng.randn(3))
                  for k, a in enumerate(side)]
        xyz = np.stack([x for _, x in atoms])
        near = np.linalg.norm(xyz[:, None] - heavy[None], axis=-1).min()
        if near < POCKET_CUTOFF:
            residues.append((near, res, atoms))
    residues.sort(key=lambda r: r[0])
    while sum(len(r[2]) for r in residues) > max_atoms:
        residues.pop()

    def line(rec, serial, name, resn, chain, resid, xyz, elem):
        return (f"{rec:<6}{serial:>5} {name:<4} {resn:>3} {chain}{resid:>4}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{0.0:6.2f}"
                f"          {elem:>2}")

    rows = []
    for j, (_, res, atoms) in enumerate(residues):
        rows += [line("ATOM", len(rows) + 1, name, res, "A", j + 1, xyz, name[0])
                 for name, xyz in atoms]
    n_atoms = len(rows)
    rows += [line("HETATM", n_atoms + k + 1, f"{el}{k + 1}"[:4], "LIG", "L", 1, xyz, el)
             for k, (el, xyz) in enumerate(
                 (el, x) for el, x in zip(ligand_symbols, lig) if el != "H")]
    return "\n".join(rows + ["END"]) + "\n", n_atoms
