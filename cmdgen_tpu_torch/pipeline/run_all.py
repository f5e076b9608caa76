"""Overlapped end-to-end driver: pockets -> aligned, posed molecules
(counterpart of ``cmdgen_tpu/pipeline/run_all.py``).

The four stages run as one streaming driver: the device stages (diffusion
sampling with consensus, GCPG decode, conformer embed + align) launch from
their own threads, while host chemistry (canonicalization, dedup, feature
matching) runs on the preparer thread. Stage hand-offs are bounded queues
(backpressure instead of unbounded buffering).

All device work stays on the one default stream, so the device stages
serialize on the card and the overlap is host against device (no stage
creates a stream: K2 is a cooperative launch that needs every SM, and a
kernel running beside it on another stream could make it fail). Each
device stage draws from its own ``torch.Generator``, seeded from the
run's seed; no generator is shared across threads.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import random as _random
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch.chem.mol import mol_from_smiles, write_smiles
from cmdgen_tpu_torch.chem.posp import points_to_graph
from cmdgen_tpu_torch.chem.sdf import write_sdf
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, syntax_tables
from cmdgen_tpu_torch.device import make_generator
from cmdgen_tpu_torch.models import gcpg as gcpg_mod
from cmdgen_tpu_torch.pipeline.align import align_chunks, align_entries, prepare_align_entries
from cmdgen_tpu_torch.pipeline.generate_smiles import condition_grid
from cmdgen_tpu_torch.pipeline.get_phar import (
    consensus_dbscan,
    consensus_gmm,
    consensus_kmeans,
)
from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores

_SENTINEL = object()


def _drain(q: "queue.Queue") -> None:
    """Consume a queue until its sentinel. Called by a consumer thread
    after a fatal error so upstream ``put()`` on the bounded queue never
    blocks (which would deadlock the join)."""
    while True:
        if q.get() is _SENTINEL:
            return


@dataclasses.dataclass
class PipelineConfig:
    """Knobs of the overlapped driver (throughput/quality trade-offs); the
    JAX package's fields and defaults."""

    n_clouds_per_pocket: int = 64       # stage-1 samples per pocket
    diff_timesteps: Optional[int] = None  # None => model default (T)
    n_phar_max: int = 8
    cluster_counts: Sequence[int] = (4, 5, 6)  # one hypothesis per count
    consensus_method: str = "gmm"        # gmm | kmeans | dbscan
    smiles_per_hypothesis: int = 512
    decode_batch: int = 512
    # sampling-logit temperature for the decode stage; <1 sharpens the
    # token distribution (higher validity on out-of-distribution
    # consensus hypotheses, at some diversity cost)
    decode_temperature: float = 1.0
    conditions: Optional[Dict[str, Sequence[float]]] = None
    n_conformers: int = 5
    refine_steps: int = 100
    num_keep: int = 3
    align_chunk: int = 64                # molecules per align call (align_chunks)
    size_bucket: int = 16                # atom-count padding granularity
    queue_depth: int = 8
    # pad pockets to this node-count granularity before stage-1 sampling
    # (mask-exact: padding is ignored by every reduction)
    pocket_pad_bucket: Optional[int] = 16
    # drop sampled points farther than this from the nearest pocket atom
    # before consensus pooling. Real pharmacophore points sit in contact
    # with the pocket (p99 nearest-CA distance ~4.1 Å on the corpus; the
    # reference's pocket is the <=8 Å shell around the ligand,
    # process_crossdock.py:67-75): 6 Å keeps all data-like points and
    # removes diverged sampler output.
    contact_filter: Optional[float] = 6.0
    # rank-by-match output stage (opt-in): score every aligned molecule
    # against its hypothesis graph (chem.match) and keep only the top
    # fraction, best-first; stats records the mean match of all aligned
    # molecules and of the kept set
    keep_top_match_frac: Optional[float] = None
    match_workers: int = 8
    # hypothesis validity gate (opt-in): decode a probe batch per
    # hypothesis first and skip the full decode volume for hypotheses
    # whose probe validity falls below the threshold. Probe decodes are
    # not shipped and not counted in raw/valid_smiles; their cost stays in
    # decode_busy_s and the drop counts are reported (gate_dropped /
    # gate_probe_smiles).
    validity_gate: Optional[float] = None
    validity_probe: int = 256
    # syntax-constrained decoding (models.gcpg.generate constraints=)
    constrain_decode: bool = False
    # additionally mask valence-overflow continuations (implies the
    # tables of constrain_decode)
    constrain_valence: bool = False


@dataclasses.dataclass
class PipelineResult:
    smiles: str
    hypothesis: int                      # hypothesis id
    rmsd: float                          # best feature-RMSD onto the points
    conformers: List[Tuple[float, np.ndarray]]  # (rmsd, coords) best-first
    # the parsed molecule the conformer coords are ordered by (the SDF
    # writer uses its atom order)
    mol: Optional[object] = None


def _flatten_cloud_dict(clouds: Dict) -> Tuple[np.ndarray, List[str]]:
    coords, families = [], []
    for _mol, feats in clouds.items():
        for fam, pts in feats.items():
            for p in pts:
                coords.append(p)
                families.append(fam)
    return np.asarray(coords, dtype=np.float32), families


def contact_filter_points(
    pts: np.ndarray, fams: List[str], pocket_coords: np.ndarray,
    cutoff: float,
) -> Tuple[np.ndarray, List[str], int]:
    """Keep sampled points within ``cutoff`` of the nearest pocket atom.
    Returns (pts, fams, n_dropped)."""
    near = np.linalg.norm(
        pts[:, None, :] - pocket_coords[None, :, :], axis=-1
    ).min(axis=1) <= cutoff
    return (
        pts[near],
        [f for f, m in zip(fams, near) if m],
        int((~near).sum()),
    )


_CONSENSUS = {
    "gmm": consensus_gmm,
    "kmeans": consensus_kmeans,
    "dbscan": lambda coords, fams, n_clusters, seed, device: consensus_dbscan(
        coords, fams, device=device
    ),
}


def run_pipeline(
    diff_model,
    gcpg_model,
    tokenizer: Tokenizer,
    pockets: Sequence[Tuple[np.ndarray, np.ndarray]],  # (coords, onehot)
    seed: int = 0,
    cfg: PipelineConfig = PipelineConfig(),
    collect: Optional[Dict] = None,
) -> Tuple[List[PipelineResult], Dict[str, float]]:
    """Run the full pocket->aligned-molecules pipeline, overlapped, on the
    models' device (both models must be on the same one).

    Returns (results, stats). ``stats`` includes the end-to-end
    ``aligned_mols_per_min`` over the wall time of the whole call.
    ``collect``: an optional dict the driver fills with the consensus
    hypotheses ({hid: (types, coords)}) and per-hypothesis unique SMILES.
    """
    dev = diff_model.device
    if gcpg_model.pos.device != dev:
        raise ValueError(f"the DiffPhar model is on {dev}, the GCPG on "
                         f"{gcpg_model.pos.device}")
    q_hyp: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
    q_raw: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
    q_prep: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
    results: List[PipelineResult] = []
    errors: List[BaseException] = []
    hyp_graphs: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    stats = {
        "pockets": len(pockets), "hypotheses": 0, "raw_smiles": 0,
        "valid_smiles": 0, "unique_smiles": 0, "matched": 0, "aligned": 0,
        # per-stage busy seconds (threads overlap, so these can sum past
        # wall_s; the largest one is the pipeline's bottleneck)
        "sample_busy_s": 0.0, "consensus_busy_s": 0.0, "decode_busy_s": 0.0,
        "prep_busy_s": 0.0, "align_busy_s": 0.0,
    }
    g_sample, g_decode, g_align = (
        make_generator(dev, s) for s in np.random.SeedSequence(seed).generate_state(3))
    py_rng = _random.Random(0)
    grid = condition_grid(cfg.conditions)
    consensus_fn = _CONSENSUS[cfg.consensus_method]

    def sampler():
        try:
            for coords, onehot in pockets:
                t0 = time.perf_counter()
                clouds = sample_pharmacophores(
                    diff_model, coords, onehot, cfg.n_clouds_per_pocket,
                    n_phar_max=cfg.n_phar_max,
                    batch_size=cfg.n_clouds_per_pocket,
                    timesteps=cfg.diff_timesteps,
                    pocket_pad_bucket=cfg.pocket_pad_bucket,
                    generator=g_sample,
                )
                stats["sample_busy_s"] += time.perf_counter() - t0
                pts, fams = _flatten_cloud_dict(clouds)
                if len(pts) == 0:
                    continue
                if cfg.contact_filter is not None:
                    pts, fams, dropped = contact_filter_points(
                        pts, fams, np.asarray(coords), cfg.contact_filter
                    )
                    stats["contact_filtered"] = stats.get(
                        "contact_filtered", 0
                    ) + dropped
                    if len(pts) < 2:
                        continue
                for nc in cfg.cluster_counts:
                    t0 = time.perf_counter()
                    cons = consensus_fn(pts, fams, n_clusters=nc, seed=nc, device=dev)
                    stats["consensus_busy_s"] += time.perf_counter() - t0
                    if len(cons) < 2:
                        continue
                    types = [t for t, _ in cons]
                    ppc = np.stack([c for _, c in cons]).astype(np.float32)
                    pp_h, pp_e, pp_m = points_to_graph(types, ppc, py_rng)
                    hid = stats["hypotheses"]
                    stats["hypotheses"] += 1
                    if collect is not None:
                        collect.setdefault("hypotheses", {})[hid] = (
                            list(types), ppc.copy()
                        )
                    hyp_graphs[hid] = (pp_h, pp_e, pp_m)
                    q_hyp.put((hid, types, ppc, pp_h, pp_e, pp_m))
        except BaseException as e:  # propagate to the main thread
            errors.append(e)
        finally:
            q_hyp.put(_SENTINEL)

    decode_tables = (
        torch.from_numpy(syntax_tables(tokenizer)).to(dev)
        if cfg.constrain_decode or cfg.constrain_valence else None
    )

    def decode(graph, cond) -> List[str]:
        """One sampled decode batch of the hypothesis graph under one
        condition row: decode_batch strings."""
        b = cfg.decode_batch
        cond = torch.from_numpy(np.asarray(cond, np.float32)).to(dev)
        toks = gcpg_mod.generate(
            gcpg_model, *(a.expand(b, *a.shape) for a in graph),
            cond.expand(b, cond.shape[0]),
            random_sample=True,
            temperature=cfg.decode_temperature,
            constraints=decode_tables,
            valence=cfg.constrain_valence,
            generator=g_decode,
        )
        return tokenizer.get_text(toks.cpu().numpy())

    def decoder():
        try:
            while True:
                item = q_hyp.get()
                if item is _SENTINEL:
                    break
                hid, types, ppc, pp_h, pp_e, pp_m = item
                graph = [torch.from_numpy(a).to(dev) for a in (pp_h, pp_e, pp_m)]
                if cfg.validity_gate is not None:
                    # probe draw: a full batch, validity parsed on this
                    # thread (a few hundred strings vs the preparer's
                    # thousands)
                    t0 = time.perf_counter()
                    probe = decode(graph, grid[0])[: cfg.validity_probe]
                    n_ok = sum(
                        1 for s in probe if mol_from_smiles(s) is not None
                    )
                    stats["decode_busy_s"] += time.perf_counter() - t0
                    stats["gate_probe_smiles"] = stats.get(
                        "gate_probe_smiles", 0
                    ) + len(probe)
                    pv = n_ok / max(len(probe), 1)
                    if collect is not None:
                        collect.setdefault("probe_validity", {})[hid] = pv
                    if pv < cfg.validity_gate:
                        stats["gate_dropped"] = stats.get(
                            "gate_dropped", 0
                        ) + 1
                        continue
                raw: List[str] = []
                remaining = cfg.smiles_per_hypothesis
                ci = 0
                t0 = time.perf_counter()
                while remaining > 0:
                    raw.extend(decode(graph, grid[ci % len(grid)]))
                    ci += 1
                    remaining -= cfg.decode_batch
                stats["decode_busy_s"] += time.perf_counter() - t0
                stats["raw_smiles"] += len(raw)
                q_raw.put((hid, types, ppc, raw))
        except BaseException as e:
            errors.append(e)
            _drain(q_hyp)
        finally:
            q_raw.put(_SENTINEL)

    def preparer():
        try:
            while True:
                item = q_raw.get()
                if item is _SENTINEL:
                    break
                hid, types, ppc, raw = item
                t0 = time.perf_counter()
                # parse each raw decode exactly once: the parsed Mol serves
                # canonicalization (dedupe key), feature matching, conformer
                # embedding and the final SDF write (PipelineResult.mol)
                mol_by_canon: Dict[str, object] = {}
                n_valid = 0
                for s in raw:
                    m = mol_from_smiles(s)
                    if m is None:
                        continue
                    n_valid += 1
                    mol_by_canon.setdefault(write_smiles(m), m)
                stats["valid_smiles"] += n_valid
                if collect is not None:
                    collect.setdefault("hyp_validity", {})[hid] = (
                        n_valid / max(len(raw), 1)
                    )
                uniq = list(mol_by_canon)
                stats["unique_smiles"] += len(uniq)
                if collect is not None:
                    collect.setdefault("uniq", {}).setdefault(
                        hid, []
                    ).extend(uniq)
                entries = prepare_align_entries(
                    [mol_by_canon[c] for c in uniq], types
                )
                stats["matched"] += len(entries)
                for chunk in align_chunks(entries, cfg.size_bucket, cfg.align_chunk):
                    stats["prep_busy_s"] += time.perf_counter() - t0
                    q_prep.put((hid, ppc, uniq, chunk))
                    t0 = time.perf_counter()
                stats["prep_busy_s"] += time.perf_counter() - t0
        except BaseException as e:
            errors.append(e)
            _drain(q_raw)
        finally:
            q_prep.put(_SENTINEL)

    def aligner():
        try:
            while True:
                item = q_prep.get()
                if item is _SENTINEL:
                    break
                hid, ppc, uniq, chunk = item
                t0 = time.perf_counter()
                res = align_entries(
                    chunk, ppc, g_align, n_conformers=cfg.n_conformers,
                    num_keep=cfg.num_keep, refine_steps=cfg.refine_steps,
                    bucket=cfg.size_bucket,
                )
                stats["align_busy_s"] += time.perf_counter() - t0
                for idx, mol, _ in chunk:
                    if idx in res:
                        confs = res[idx]
                        results.append(PipelineResult(
                            smiles=uniq[idx], hypothesis=hid,
                            rmsd=confs[0][0], conformers=confs, mol=mol,
                        ))
                stats["aligned"] = len(results)
        except BaseException as e:
            errors.append(e)
            _drain(q_prep)

    threads = [
        threading.Thread(target=f, name=f.__name__, daemon=True)
        for f in (sampler, decoder, preparer, aligner)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    stats["wall_s"] = round(wall, 2)
    stats["aligned_mols_per_min"] = round(len(results) / wall * 60.0, 1)
    if cfg.keep_top_match_frac is not None and results:
        # post-alignment rank-by-match selection (throughput above is the
        # pre-selection number; both match means are reported)
        from cmdgen_tpu_torch.chem.match import get_match_scores

        t0 = time.perf_counter()
        scores = get_match_scores(
            [hyp_graphs[r.hypothesis] for r in results],
            [r.smiles for r in results],
            n_workers=cfg.match_workers,
        )
        ok = [s for s in scores if s >= 0]
        stats["match_score_all_aligned"] = (
            round(float(np.mean(ok)), 4) if ok else -1.0
        )
        keep = max(1, int(len(results) * cfg.keep_top_match_frac))
        order = sorted(
            range(len(results)),
            key=lambda i: (scores[i] if scores[i] >= 0 else -1.0),
            reverse=True,
        )[:keep]
        results = [results[i] for i in order]
        kept_ok = [scores[i] for i in order if scores[i] >= 0]
        stats["match_score_kept"] = (
            round(float(np.mean(kept_ok)), 4) if kept_ok else -1.0
        )
        stats["kept"] = len(results)
        stats["match_rank_busy_s"] = time.perf_counter() - t0
    for k in list(stats):
        if k.endswith("_busy_s"):
            stats[k] = round(stats[k], 2)
    return results, stats


def write_pipeline_results(results: Sequence[PipelineResult], out_dir):
    """Write each aligned molecule as a posed multi-conformer SDF
    (mol_<hyp>_<i>.sdf, best conformer first) plus results.json with the
    per-molecule best RMSD — the artifact layout of the reference's stage-4
    output directory (align_test_wrn.py)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    index = []
    for i, r in enumerate(results):
        # the stored Mol's atom order is what the conformer coords follow;
        # re-parsing the canonical string is only the fallback for results
        # constructed without one
        mol = r.mol if r.mol is not None else mol_from_smiles(r.smiles)
        if mol is None:
            continue
        symbols = [a.symbol for a in mol.atoms]
        bonds = [(bd.a1, bd.a2, bd.order) for bd in mol.bonds]
        mols = [
            (symbols, coords, f"{r.smiles} rmsd={e:.3f}")
            for e, coords in r.conformers
        ]
        path = out_dir / f"mol_{r.hypothesis}_{i}.sdf"
        write_sdf(path, mols, bonds_list=[bonds] * len(mols))
        index.append({
            "file": path.name, "smiles": r.smiles,
            "hypothesis": r.hypothesis, "rmsd": round(r.rmsd, 4),
        })
    (out_dir / "results.json").write_text(json.dumps(index, indent=1))
    return out_dir / "results.json"
