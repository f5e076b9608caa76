"""Scientific evaluation harnesses (counterpart of
``cmdgen_tpu/pipeline/evaluate.py``).

- eval_diffphar: DiffPhar/test.py:34-227 — sample pharmacophore clouds per
  test pocket and compare against the reference pharmacophores (CoM distance
  to the reference centroid, max pairwise spread, per-type histograms + KL).
- eval_alignment_rmsd / eval_alignment_rmsd_posed: the aligned conformers'
  RMSD against a molecule's reference pose
  (PharAlign/align_ligandpharm_gcpg_test.py:339-562).
- eval_gcpg: GCPG/test_generation.py:87-269 — generate SMILES for test
  pharmacophore graphs and score match / validity / uniqueness / novelty.

Randomness comes from an explicit ``torch.Generator``; ``eval_diffphar``
also takes the sampler's draws per pocket (``noise=``) and ``eval_gcpg``
the decode's prior ``z`` and Gumbel tensor, so that a test can feed the
JAX package's own draws. Every device computation runs on the model's
device (or the generator's).
"""
from __future__ import annotations

import random as _random
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cmdgen_tpu_torch.chem import metrics as qmetrics
from cmdgen_tpu_torch.chem.constants import PHAR_DECODER, PHAR_HIST
from cmdgen_tpu_torch.chem.match import get_match_scores
from cmdgen_tpu_torch.chem.ppgraph import smiles_to_ppgraph
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.data.dataset import DiffPharDataset
from cmdgen_tpu_torch.device import DeviceLike, make_generator, resolve_device
from cmdgen_tpu_torch.ops.kabsch import aligned_rmsd


def eval_diffphar(
    model,
    dataset: DiffPharDataset,
    n_pockets: int = 20,
    n_samples_per_pocket: int = 4,
    timesteps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence] = None,
) -> Dict[str, float]:
    """Distribution-match eval (test.py). Returns summary metrics.

    ``noise``: one ``sample_given_pocket`` draw triple per pocket, used
    instead of ``generator``."""
    dev = model.device
    com_dists: List[float] = []
    spreads_gen: List[float] = []
    spreads_ref: List[float] = []
    type_hist = np.zeros(len(PHAR_DECODER))
    n_pockets = min(n_pockets, len(dataset))
    for i in range(n_pockets):
        batch = dataset.padded_batch([i] * n_samples_per_pocket)
        pocket = PointCloud(
            x=torch.as_tensor(batch["pocket_x"], device=dev),
            h=torch.as_tensor(batch["pocket_h"], device=dev),
            mask=torch.as_tensor(batch["pocket_mask"], device=dev),
        )
        ref_x = batch["phar_x"][0]
        ref_mask = batch["phar_mask"][0] > 0.5
        ref_pts = ref_x[ref_mask]
        n_ref = int(ref_mask.sum())
        out, _ = model.sample_given_pocket(
            pocket, torch.full((n_samples_per_pocket,), n_ref, device=dev),
            dataset.n_phar_max, timesteps=timesteps, generator=generator,
            noise=None if noise is None else noise[i],
        )
        x = out.x.cpu().numpy()
        h = out.h.cpu().numpy()
        m = out.mask.cpu().numpy() > 0.5
        ref_com = ref_pts.mean(axis=0)
        for s in range(n_samples_per_pocket):
            pts = x[s][m[s]]
            if len(pts) == 0:
                continue
            com_dists.append(float(np.linalg.norm(pts.mean(0) - ref_com)))
            if len(pts) > 1:
                d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
                spreads_gen.append(float(d.max()))
            types = h[s][m[s]].argmax(-1)
            for t in types:
                type_hist[int(t)] += 1
        if n_ref > 1:
            d = np.sqrt(((ref_pts[:, None] - ref_pts[None]) ** 2).sum(-1))
            spreads_ref.append(float(d.max()))
    ref_hist = np.asarray([PHAR_HIST[k] for k in PHAR_DECODER], dtype=float)
    return {
        "com_dist_mean": float(np.mean(com_dists)) if com_dists else np.nan,
        "spread_gen_mean": float(np.mean(spreads_gen)) if spreads_gen else np.nan,
        "spread_ref_mean": float(np.mean(spreads_ref)) if spreads_ref else np.nan,
        "kl_types": qmetrics.categorical_kl(type_hist, ref_hist),
        "n_sampled": int(sum(type_hist)),
    }


def _generator(generator: Optional[torch.Generator], device: DeviceLike):
    return generator if generator is not None else make_generator(resolve_device(device), 0)


def eval_alignment_rmsd(
    smiles_list: Sequence[str],
    reference_coords: Sequence[np.ndarray],
    posp_path,
    generator: Optional[torch.Generator] = None,
    n_conformers: int = 10,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Aligned-conformer vs reference-pose RMSD: align each molecule onto
    the pharmacophore, then report the minimum heavy-atom RMSD between the
    aligned conformers and the molecule's reference pose coordinates."""
    from cmdgen_tpu_torch.pipeline.align import align_batch, load_pp_points

    generator = _generator(generator, device)
    pp_coords, pp_types = load_pp_points(posp_path)
    results = align_batch(
        smiles_list, pp_coords, pp_types, generator, n_conformers=n_conformers,
        num_keep=n_conformers,
    )
    rmsds = []
    for i, res in results.items():
        ref = np.asarray(reference_coords[i], dtype=np.float32)
        best = np.inf
        for _, conf in res:
            if conf.shape != ref.shape:
                continue
            r = float(aligned_rmsd(torch.as_tensor(conf, dtype=torch.float32),
                                   torch.from_numpy(ref)))
            best = min(best, r)
        if np.isfinite(best):
            rmsds.append(best)
    return {
        "rmsd_mean": float(np.mean(rmsds)) if rmsds else float("nan"),
        "rmsd_median": float(np.median(rmsds)) if rmsds else float("nan"),
        "n_aligned": len(rmsds),
        "rmsd_values": rmsds,
    }


def pose_ligand(path, ref_ligand: Optional[str] = None):
    """(element symbols, coordinates [N, 3]) of a pose PDB's ligand: the
    ``chain:resid`` selection, else every heavy atom that is not water."""
    from cmdgen_tpu_torch.chem.pdb import ligand_atoms, parse_pdb

    residues = parse_pdb(path)
    if ref_ligand is not None:
        atoms = ligand_atoms(residues, ref_ligand)
    else:
        # a pose file usually holds just the ligand: all heavy atoms
        atoms = [a for r in residues for a in r.atoms
                 if a.element != "H" and r.res_name != "HOH"]
    if not atoms:
        raise ValueError(f"no ligand atoms in {path}")
    return [a.element for a in atoms], np.stack([a.coord for a in atoms])


def _rmsd_or_nan(conf, pose: torch.Tensor) -> float:
    """Kabsch-aligned RMSD of a conformer onto the pose; NaN for a
    conformer with a non-finite coordinate."""
    conf = torch.as_tensor(conf, dtype=torch.float32)
    if not torch.isfinite(conf).all():
        return float("nan")
    return float(aligned_rmsd(conf, pose))


def eval_alignment_rmsd_posed(
    pose_pdb_paths: Sequence,
    posp_path,
    ref_ligand: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    n_conformers: int = 10,
    tolerance: int = 1,
    out_dir=None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Posed-PDB-ligand RMSD evaluation: parse each docked-pose PDB ligand,
    re-embed + align it onto the pharmacophore with tolerance subsets, and
    report the minimum heavy-atom RMSD between the aligned conformers and
    the reference pose. Writes ``rmsd_values.npy`` (only the finite values)
    when ``out_dir`` is given.

    Deviations from the reference, as in the JAX package: bonds are
    perceived by ``chem/mol_build.build_molecule`` (covalent-radius
    connectivity + valence-gated order perception) instead of
    Chem.MolFromPDBFile, and the RMSD compares the aligned conformer with
    the pose coordinates after Kabsch superposition (the reference
    re-embeds both molecules and subtracts them without superposition).
    A molecule that fails anywhere is counted in ``n_failed`` and skipped.
    """
    from cmdgen_tpu_torch.chem.mol_build import build_molecule
    from cmdgen_tpu_torch.pipeline.align import align_molecule, load_pp_points

    generator = _generator(generator, device)
    pp_coords, pp_types = load_pp_points(posp_path)
    rmsds = []
    n_failed = 0
    for path in pose_pdb_paths:
        try:
            symbols, pose = pose_ligand(path, ref_ligand)
            mol = build_molecule(symbols, pose)
            res = align_molecule(
                mol, pp_coords, pp_types, generator,
                n_conformers=n_conformers, num_keep=n_conformers,
                tolerance=tolerance,
            )
            if not res:
                raise ValueError("no alignment")
            pose_t = torch.as_tensor(pose, dtype=torch.float32)
            # align_molecule keeps diverged conformers, last: as in the JAX
            # package, where the SVD of a non-finite conformer gives a NaN
            # RMSD (torch's raises), the best is the first conformer's
            # unless a later one is lower, so NaN only if the first is
            best = min(_rmsd_or_nan(conf, pose_t) for _, conf, _ in res)
            rmsds.append(best)
        except Exception:
            n_failed += 1  # per-molecule try/except-and-skip, as the reference
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        if rmsds:
            np.save(out_dir / "rmsd_values.npy", np.asarray(rmsds, np.float32))
    return {
        "rmsd_mean": float(np.mean(rmsds)) if rmsds else float("nan"),
        "rmsd_median": float(np.median(rmsds)) if rmsds else float("nan"),
        "n_aligned": len(rmsds),
        "n_failed": n_failed,
        "rmsd_values": rmsds,
    }


# generate.py's fixed condition grid: the fallback for molecules the
# descriptors reject
DEFAULT_CONDITIONS = [400.0, 4.0, 0.6, 4.0, 4.0, 0.0, 0.0]


def true_conditions(smiles: Sequence[str]) -> np.ndarray:
    """Each molecule's own properties as the GCPG condition row [MW, logP,
    QED, SAS, RotaNumBonds, 0, 0] (test_generation.py:132-136)."""
    from cmdgen_tpu_torch.chem.descriptors import all_properties

    rows = []
    for s in smiles:
        p = all_properties(s)
        rows.append([p["MW"], p["logP"], p["QED"], p["SAS"], p["RotaNumBonds"], 0.0, 0.0]
                    if p else DEFAULT_CONDITIONS)
    return np.asarray(rows, dtype=np.float32)


def eval_gcpg(
    model,
    tokenizer,
    test_smiles: Sequence[str],
    n_molecules: int = 100,
    conditions: Optional[np.ndarray] = None,
    train_set: Optional[set] = None,
    match_workers: int = 4,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Generation eval on test pharmacophores (test_generation.py): sampled
    decode of each test molecule's pharmacophore graph on its true
    properties, then validity / uniqueness / novelty and the match score.
    ``z`` [B, H] and ``gumbel`` [max_len-1, B, V] replace the decode's
    draws from ``generator``."""
    from cmdgen_tpu_torch.models.gcpg import generate

    dev = model.pos.device
    py_rng = _random.Random(0)
    graphs, used = [], []
    for s in test_smiles:
        if len(graphs) >= n_molecules:
            break
        g = smiles_to_ppgraph(s, py_rng)
        if g is not None:
            graphs.append(g[:3])
            used.append(s)
    if not graphs:
        return {"n_eval": 0}

    def stack(k):
        return torch.as_tensor(np.stack([g[k] for g in graphs]), device=dev)

    if conditions is None:
        # the reference conditions on each test molecule's TRUE properties
        conditions = true_conditions(used)
    with torch.no_grad():
        toks = generate(
            model, stack(0), stack(1), stack(2),
            torch.as_tensor(conditions, dtype=torch.float32, device=dev),
            random_sample=True, z=z, gumbel=gumbel, generator=generator,
        )
    smiles_out = tokenizer.get_text(toks.cpu().numpy())
    out = qmetrics.evaluate_set(smiles_out, train_set=train_set)
    scores = get_match_scores(
        [tuple(np.asarray(a) for a in g) for g in graphs],
        smiles_out, n_workers=match_workers, timeout=20,
    )
    valid_scores = [s for s in scores if s >= 0]
    out["match_score"] = float(np.mean(valid_scores)) if valid_scores else -1.0
    out["match_timeout_rate"] = float(np.mean([s == -2 for s in scores]))
    out["n_eval"] = len(smiles_out)
    return out
