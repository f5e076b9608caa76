"""PharAlign: embed generated molecules and align them onto the pharmacophore
(counterpart of ``cmdgen_tpu/pipeline/align.py``).

For each generated SMILES and each tolerance-k subset of the pharmacophore
points, match molecule features to the points, embed conformers (distance
geometry with pharmacophore constraints, ``ops/dgeom.py``), align the
matched feature centroids onto the point coordinates with a batched Kabsch,
and keep the best conformers by RMSD, writing posed SDF files.

The device work runs on an explicit ``device`` (default ``cuda``) and draws
from an explicit ``torch.Generator``. The Kabsch runs in float64, and a
conformer whose centroids are not finite is given the points themselves as
a stand-in before the batched SVD (which raises on a non-finite matrix)
and dropped afterwards, as the JAX package drops its NaN RMSD.
"""
from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch.chem.features import GCPG_MAPPING, get_features
from cmdgen_tpu_torch.chem.mol import Mol, mol_from_smiles
from cmdgen_tpu_torch.chem.sdf import write_sdf
from cmdgen_tpu_torch.device import DeviceLike, make_generator, resolve_device
from cmdgen_tpu_torch.ops.dgeom import (
    embed_conformers,
    embed_conformers_padded,
    padded_bounds,
)
from cmdgen_tpu_torch.ops.kabsch import apply_rigid, kabsch

# posp code -> GCPG 1-based family index (shared with match scoring)
_POSP2GCPG = {
    "AROM": 1, "HYBL": 2, "POSC": 3, "HACC": 4, "HDON": 5, "LHYBL": 6,
    "UNKNOWN": 7,
}
# an RMSD past this (Å) is a diverged embedding, not a pose
MAX_RMSD = 1e3

Entry = Tuple[int, Mol, List[Tuple[int, ...]]]


def load_pp_points(posp_path) -> Tuple[np.ndarray, List[str]]:
    """.posp -> (coords [K,3], type codes)."""
    coords, types = [], []
    for line in Path(posp_path).read_text().strip().split("\n"):
        parts = line.strip().split()
        types.append(parts[0])
        coords.append([float(v) for v in parts[-3:]])
    return np.asarray(coords, dtype=np.float32), types


def generate_subsets_with_tolerance(k: int, tolerance: int):
    """Index subsets dropping up to ``tolerance`` points
    (align_test_wrn.py:340-347), largest subsets first."""
    out = []
    for drop in range(0, tolerance + 1):
        if k - drop < 2:
            break
        for keep in itertools.combinations(range(k), k - drop):
            out.append(list(keep))
    return out


def match_features_to_points(
    mol: Mol, point_types: Sequence[str]
) -> Optional[List[Tuple[int, ...]]]:
    """Greedy assignment of one perceived feature atom-set per point.

    Returns atom groups (one per point) or None if some point has no
    candidate (the reference's MatchPharmacophoreToMol failure path).
    """
    feats = get_features(mol) or []
    by_idx: Dict[int, List[Tuple[int, ...]]] = {}
    for fam, atoms in feats:
        by_idx.setdefault(GCPG_MAPPING.get(fam, 7), []).append(atoms)
    chosen: List[Tuple[int, ...]] = []
    used: set = set()
    for t in point_types:
        idx = _POSP2GCPG.get(t, 7)
        cands = by_idx.get(idx, [])
        pick = None
        for c in cands:
            if c not in used:
                pick = c
                break
        if pick is None:
            if cands:
                pick = cands[0]  # allow reuse rather than failing outright
            else:
                return None
        used.add(pick)
        chosen.append(pick)
    # a rigid alignment needs at least two geometrically distinct anchors;
    # e.g. AROM + LHYBL of the same ring share a centroid and degenerate
    if len(set(chosen)) < 2:
        return None
    return chosen


def group_matrix(groups: Sequence[Sequence[int]], n: int) -> np.ndarray:
    """[G, n] centroid weights: 1/|group| on each group's atoms."""
    gm = np.zeros((len(groups), n), dtype=np.float32)
    for k, atoms in enumerate(groups):
        for a in atoms:
            gm[k, a] = 1.0 / len(atoms)
    return gm


def pose_conformers(confs: torch.Tensor, gmat: torch.Tensor, points: torch.Tensor):
    """Kabsch of each conformer's feature centroids onto the points.

    confs [..., N, 3], gmat [..., G, N] (broadcast over the conformer
    axes), points [G, 3]. Returns (posed conformers [..., N, 3] float32,
    RMSDs [...] float64, NaN where a centroid is not finite). The rotation
    and the errors are formed in float64: a diverged conformer's squared
    errors overflow float32."""
    cents = (gmat @ confs).double()
    tgt = points.double().expand_as(cents)
    ok = torch.isfinite(cents).all(-1).all(-1)
    cents = torch.where(ok[..., None, None], cents, tgt)
    r, t = kabsch(cents, tgt)
    errs = ((apply_rigid(r, t, cents) - tgt) ** 2).sum(-1).mean(-1).sqrt()
    errs = torch.where(ok, errs, torch.full_like(errs, float("nan")))
    posed = apply_rigid(r.float(), t.float(), confs)
    return posed, errs


def _keep_best(errs: np.ndarray, posed: np.ndarray, n_atoms: int, num_keep: int):
    """[(rmsd, coords [n_atoms, 3])] of the best finite conformers, best
    first; None when none is finite and below MAX_RMSD."""
    finite = np.isfinite(errs) & (errs < MAX_RMSD)
    if not finite.any():
        return None
    order = np.argsort(np.where(finite, errs, np.inf))[:num_keep]
    return [(float(errs[c]), posed[c, :n_atoms]) for c in order if finite[c]]


def align_molecule(
    smiles,
    pp_coords: np.ndarray,
    pp_types: Sequence[str],
    generator: Optional[torch.Generator] = None,
    n_conformers: int = 10,
    num_keep: int = 3,
    tolerance: int = 0,
    refine_steps: int = 200,
    device: DeviceLike = None,
):
    """Embed + align one molecule (a SMILES string or an already-built
    chem Mol) on ``device`` (or the generator's). Returns list of (rmsd,
    conformer coords aligned into the pharmacophore frame, kept point
    indices) sorted by RMSD, or None if the molecule can't be matched."""
    dev = generator.device if generator is not None else resolve_device(device)
    mol = mol_from_smiles(smiles) if isinstance(smiles, str) else smiles
    if mol is None:
        return None
    for keep in generate_subsets_with_tolerance(len(pp_types), tolerance):
        sub_coords = pp_coords[keep]
        groups = match_features_to_points(mol, [pp_types[i] for i in keep])
        if groups is None:
            continue
        targets = np.sqrt(
            ((sub_coords[:, None, :] - sub_coords[None, :, :]) ** 2).sum(-1)
        )
        confs = embed_conformers(
            mol, n_conformers, refine_steps=refine_steps,
            centroid_groups=groups, centroid_targets=targets,
            centroid_weight=2.0, generator=generator, device=dev,
        )  # [C, N, 3]
        posed, errs = pose_conformers(
            confs, torch.from_numpy(group_matrix(groups, mol.n_atoms)).to(dev),
            torch.from_numpy(np.asarray(sub_coords, np.float32)).to(dev))
        # every conformer is kept here, as in the JAX package (NaNs last)
        errs, posed = errs.cpu().numpy(), posed.cpu().numpy()
        order = np.argsort(errs, kind="stable")[:num_keep]
        return [(float(errs[c]), posed[c], list(keep)) for c in order]
    return None


def prepare_align_entries(
    smiles_list: Sequence[str], pp_types: Sequence[str]
) -> List[Entry]:
    """Host half of batched alignment: parse each SMILES and match its
    perceived features to the pharmacophore point types. Returns
    [(index, mol, atom groups)] for the molecules that matched — pure
    Python, safe to run on a worker thread while the device aligns the
    previous batch."""
    entries = []
    for i, s in enumerate(smiles_list):
        mol = mol_from_smiles(s) if isinstance(s, str) else s
        if mol is None:
            continue
        groups = match_features_to_points(mol, pp_types)
        if groups is None:
            continue
        entries.append((i, mol, groups))
    return entries


def size_buckets(entries: Sequence[Entry], bucket: int) -> Dict[int, List[Entry]]:
    """Prepared entries grouped by atom count padded up to a multiple of
    ``bucket``: {padded size: entries}, one embedding call each."""
    buckets: Dict[int, List[Entry]] = {}
    for e in entries:
        buckets.setdefault(-(-e[1].n_atoms // bucket) * bucket, []).append(e)
    return buckets


def align_chunks(entries: Sequence[Entry], bucket: int, align_chunk: int) -> List[List[Entry]]:
    """Prepared entries as run-all's align calls: each size bucket in
    pieces of at most ``align_chunk`` molecules (only real rows: the JAX
    package's fill to a fixed size served its compile cache)."""
    return [ents[i : i + align_chunk] for ents in size_buckets(entries, bucket).values()
            for i in range(0, len(ents), align_chunk)]


def align_entries(
    entries: Sequence[Entry],
    pp_coords: np.ndarray,
    generator: Optional[torch.Generator] = None,
    n_conformers: int = 10,
    num_keep: int = 3,
    refine_steps: int = 200,
    bucket: int = 16,
    device: DeviceLike = None,
) -> Dict[int, list]:
    """Device half of batched alignment: embed + Kabsch the prepared
    entries, one batched call per size bucket (atom counts padded up to a
    multiple of ``bucket``), on ``device`` (or the generator's).

    Returns {index: [(rmsd, aligned conformer coords [n_atoms,3]), ...]};
    a conformer whose RMSD is not finite or not below MAX_RMSD is dropped,
    and a molecule with none left.
    """
    dev = generator.device if generator is not None else resolve_device(device)
    k = pp_coords.shape[0]
    targets = np.sqrt(
        ((pp_coords[:, None, :] - pp_coords[None, :, :]) ** 2).sum(-1)
    ).astype(np.float32)
    points = torch.from_numpy(np.asarray(pp_coords, np.float32)).to(dev)

    results: Dict[int, list] = {}
    for n_pad, ents in size_buckets(entries, bucket).items():
        lo, up, amask = padded_bounds([e[1] for e in ents], n_pad)
        m = len(ents)
        gmat = np.stack([group_matrix(groups, n_pad) for _, _, groups in ents])
        gmat_t = torch.from_numpy(gmat).to(dev)
        confs = embed_conformers_padded(
            *(torch.from_numpy(a).to(dev) for a in (lo, up, amask)),
            n_conformers, refine_steps=refine_steps,
            groups=gmat_t,
            targets=torch.from_numpy(targets).to(dev).expand(m, k, k),
            centroid_weight=2.0, generator=generator,
        )  # [M, C, Nb, 3]
        posed, errs = pose_conformers(confs, gmat_t[:, None], points)
        posed, errs = posed.cpu().numpy(), errs.cpu().numpy()
        for mi, (idx, mol, _) in enumerate(ents):
            res = _keep_best(errs[mi], posed[mi], mol.n_atoms, num_keep)
            if res is not None:
                results[idx] = res
    return results


def align_batch(
    smiles_list: Sequence[str],
    pp_coords: np.ndarray,
    pp_types: Sequence[str],
    generator: Optional[torch.Generator] = None,
    n_conformers: int = 10,
    num_keep: int = 3,
    refine_steps: int = 200,
    bucket: int = 16,
    device: DeviceLike = None,
):
    """Batched alignment: all molecules of a size bucket embed in one call.

    Returns {index: [(rmsd, aligned conformer coords [n_atoms,3]), ...]}.
    """
    entries = prepare_align_entries(smiles_list, pp_types)
    return align_entries(
        entries, np.asarray(pp_coords, dtype=np.float32), generator,
        n_conformers=n_conformers, num_keep=num_keep,
        refine_steps=refine_steps, bucket=bucket, device=device,
    )


def align_smiles_list(
    smiles_list: Sequence[str],
    posp_path,
    out_dir,
    generator: Optional[torch.Generator] = None,
    n_conformers: int = 10,
    num_keep: int = 3,
    tolerance: int = 0,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Stage-4 CLI body (align.sh -> align_test_wrn.py): aligned SDFs +
    rmsd_values.npy. Returns {smiles: best rmsd}. Uses the batched
    embedding path; ``tolerance`` retries unmatched molecules on point
    subsets (align_test_wrn.py:340-347). Without a generator, draws from
    one seeded 0 on ``device``."""
    if generator is None:
        generator = make_generator(resolve_device(device), 0)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pp_coords, pp_types = load_pp_points(posp_path)

    results = align_batch(smiles_list, pp_coords, pp_types, generator,
                          n_conformers=n_conformers, num_keep=num_keep)
    # tolerance fallback: retry unmatched molecules on reduced subsets
    if tolerance > 0:
        missing = [i for i in range(len(smiles_list)) if i not in results]
        for keep in generate_subsets_with_tolerance(len(pp_types), tolerance):
            if len(keep) == len(pp_types) or not missing:
                continue
            part = align_batch(
                [smiles_list[i] for i in missing],
                pp_coords[keep], [pp_types[i] for i in keep], generator,
                n_conformers=n_conformers, num_keep=num_keep,
            )
            for local_i, res in part.items():
                results[missing[local_i]] = res
            missing = [i for i in missing if i not in results]

    best: Dict[str, float] = {}
    rmsds = []
    for i, res in sorted(results.items()):
        smiles = smiles_list[i]
        mol = mol_from_smiles(smiles)
        symbols = [a.symbol for a in mol.atoms]
        bonds = [(b.a1, b.a2, b.order) for b in mol.bonds]
        mols = [
            (symbols, coords, f"{smiles} rmsd={e:.3f}") for e, coords in res
        ]
        write_sdf(
            out_dir / f"mol_{i}.sdf", mols, bonds_list=[bonds] * len(mols)
        )
        best[smiles] = res[0][0]
        rmsds.append(res[0][0])
    np.save(out_dir / "rmsd_values.npy", np.asarray(rmsds, dtype=np.float32))
    return best
