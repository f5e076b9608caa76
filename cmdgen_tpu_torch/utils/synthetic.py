"""Synthetic-but-realistic geometry generators for benchmarks and tests
(a copy of ``cmdgen_tpu/utils/synthetic.py``), and writers of the files
the evaluation harnesses read: a DiffPhar test npz of synthetic complexes
and a pose PDB of one ligand."""
from __future__ import annotations

import numpy as np


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
