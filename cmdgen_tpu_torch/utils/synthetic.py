"""Synthetic-but-realistic geometry generators for benchmarks and tests
(a copy of ``cmdgen_tpu/utils/synthetic.py``)."""
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
