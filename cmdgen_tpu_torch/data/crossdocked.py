"""CrossDocked preprocessing: (pocket PDB, ligand SDF) -> training arrays.

Behavioral equivalent of DiffPhar/process_crossdock.py:54-405 (and the
CA-only variant): for each complex, extract pocket residues within 8 Å of
the ligand, perceive the ligand's pharmacophore features (position = member-
atom centroid), one-hot everything, and write ``{split}.npz`` in the same
flat-arrays-plus-index-masks layout the reference uses, plus the smoothed
joint size histogram (``size_distribution.npy``).

A copy of ``cmdgen_tpu/data/crossdocked.py`` on the port's chem modules:
the same npz layout, split draw and histograms.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cmdgen_tpu_torch.chem import pdb as pdbmod
from cmdgen_tpu_torch.chem.constants import DATASET_PARAMS, PHAR_DECODER
from cmdgen_tpu_torch.chem.features import get_features
from cmdgen_tpu_torch.chem.sdf import read_sdf
from cmdgen_tpu_torch.diffusion.size_prior import smoothed_size_histogram

# a residue with a heavy atom within this many Å of a ligand heavy atom
# belongs to the pocket
POCKET_CUTOFF = 8.0


def ligand_pharmacophores(
    mol, coords: np.ndarray, phar_encoder: Dict[str, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Feature centroids + one-hot types (process_crossdock.py:83-102)."""
    feats = get_features(mol) or []
    positions, onehot = [], []
    nf = len(phar_encoder)
    for fam, atoms in feats:
        idx = phar_encoder.get(fam, phar_encoder.get("others"))
        if idx is None:
            continue
        positions.append(coords[list(atoms)].mean(axis=0))
        v = np.zeros(nf, dtype=np.float32)
        v[idx] = 1.0
        onehot.append(v)
    if not positions:
        return np.zeros((0, 3), np.float32), np.zeros((0, nf), np.float32)
    return np.stack(positions).astype(np.float32), np.stack(onehot)


def process_complex(
    pdb_file,
    sdf_file,
    dataset: str = "crossdock_full",
    representation: str = "full-atom",
    cutoff: float = POCKET_CUTOFF,
):
    """One (pocket, ligand) pair -> dict of arrays, or None on failure."""
    params = DATASET_PARAMS[dataset]
    mols = read_sdf(sdf_file)
    if not mols:
        return None
    mol, lig_coords = mols[0]
    heavy = [i for i, a in enumerate(mol.atoms) if a.symbol != "H"]
    phar_coords, phar_onehot = ligand_pharmacophores(
        mol, lig_coords, params["phar_encoder"]
    )
    if len(phar_coords) == 0:
        return None
    residues = pdbmod.parse_pdb(pdb_file)
    pocket = pdbmod.pocket_from_ligand(
        residues, lig_coords[heavy], cutoff=cutoff
    )
    if not pocket:
        return None
    pocket_coords, pocket_onehot = pdbmod.featurize_pocket(
        pocket, representation, dataset
    )
    return {
        "phar_coords": phar_coords,
        "phar_one_hot": phar_onehot,
        "pocket_c_alpha": pocket_coords.astype(np.float32),
        "pocket_one_hot": pocket_onehot.astype(np.float32),
    }


def write_split_npz(
    out_file,
    names: List[str],
    complexes: List[Dict[str, np.ndarray]],
):
    """Concatenate per-complex arrays with integer sample-index masks
    (process_crossdock.py:199-211 / dataset.py:20-23 layout)."""
    phar_mask = np.concatenate(
        [np.full(len(c["phar_coords"]), i) for i, c in enumerate(complexes)]
    )
    pocket_mask = np.concatenate(
        [np.full(len(c["pocket_c_alpha"]), i) for i, c in enumerate(complexes)]
    )
    np.savez(
        out_file,
        names=np.asarray(names),
        phar_coords=np.concatenate([c["phar_coords"] for c in complexes]),
        phar_one_hot=np.concatenate([c["phar_one_hot"] for c in complexes]),
        phar_mask=phar_mask,
        pocket_c_alpha=np.concatenate(
            [c["pocket_c_alpha"] for c in complexes]
        ),
        pocket_one_hot=np.concatenate(
            [c["pocket_one_hot"] for c in complexes]
        ),
        pocket_mask=pocket_mask,
    )


def process_dataset(
    pairs: Sequence[Tuple[str, str, str]],
    out_dir,
    dataset: str = "crossdock_full",
    representation: str = "full-atom",
    val_fraction_from_train: int = 300,
    seed: int = 0,
):
    """pairs: [(split, pdb_file, sdf_file)]. Writes {split}.npz +
    size_distribution.npy. Per-sample failures are skipped and counted
    (process_crossdock.py:281-299)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    by_split: Dict[str, list] = {}
    names: Dict[str, list] = {}
    n_failed = 0
    for split, pdb_file, sdf_file in pairs:
        try:
            c = process_complex(pdb_file, sdf_file, dataset, representation)
        except Exception:
            c = None
        if c is None:
            n_failed += 1
            continue
        by_split.setdefault(split, []).append(c)
        names.setdefault(split, []).append(
            f"{Path(pdb_file).stem}_{Path(sdf_file).stem}"
        )
    # carve a validation split out of train if none provided
    if "val" not in by_split and "train" in by_split:
        rng = np.random.RandomState(seed)
        k = min(val_fraction_from_train, max(1, len(by_split["train"]) // 10))
        idx = rng.choice(len(by_split["train"]), size=k, replace=False)
        idx_set = set(idx.tolist())
        by_split["val"] = [by_split["train"][i] for i in sorted(idx_set)]
        names["val"] = [names["train"][i] for i in sorted(idx_set)]
    for split, complexes in by_split.items():
        write_split_npz(out_dir / f"{split}.npz", names[split], complexes)
    if "train" in by_split:
        n1 = np.array([len(c["phar_coords"]) for c in by_split["train"]])
        n2 = np.array([len(c["pocket_c_alpha"]) for c in by_split["train"]])
        hist = smoothed_size_histogram(n1, n2, sigma=1.0)
        np.save(out_dir / "size_distribution.npy", hist)
        # per-class type histograms (process_crossdock.py:185-196)
        params = DATASET_PARAMS[dataset]
        phar_counts = np.zeros(len(PHAR_DECODER), dtype=np.int64)
        aa_decoder = params.get(
            "aa_decoder", params.get("atom_decoder", [])
        )
        aa_counts = np.zeros(len(aa_decoder), dtype=np.int64)
        for c in by_split["train"]:
            phar_counts += np.bincount(
                c["phar_one_hot"].argmax(1), minlength=len(PHAR_DECODER)
            )
            aa_counts += np.bincount(
                c["pocket_one_hot"].argmax(1), minlength=len(aa_decoder)
            )
        (out_dir / "type_histograms.json").write_text(
            json.dumps(
                {
                    "phar_hist": dict(zip(PHAR_DECODER, phar_counts.tolist())),
                    "aa_hist": dict(zip(aa_decoder, aa_counts.tolist())),
                }
            )
        )
    return {"n_failed": n_failed, "splits": {k: len(v) for k, v in by_split.items()}}
