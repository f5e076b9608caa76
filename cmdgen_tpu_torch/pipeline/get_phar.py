"""Consensus pharmacophores from sampled point clouds, inference stage 2
(counterpart of ``cmdgen_tpu/pipeline/get_phar.py``).

Pool the pharmacophore points sampled for a pocket (the JSON of
``sample-phars``), cluster them (GMM / KMeans / DBSCAN), give each cluster
its most probable feature type and write a ``.posp`` hypothesis. Also the
dual-target modes (Kabsch registration of one target's cloud onto the
other, then the mutual overlap: pooled GMM, standardised DBSCAN, or
per-set GMM with a cross-set merge) and the selectivity mode (points far
from an anti-target cloud). Clustering, registration and nearest-neighbour
distances run on ``device`` (default ``cuda``; raises without CUDA); the
bookkeeping stays on the host in numpy, as in the JAX package.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch.chem.posp import FAMILY2POSP, save_posp
from cmdgen_tpu_torch.device import DeviceLike, make_generator, resolve_device
from cmdgen_tpu_torch.ops.clustering import (
    dbscan,
    gmm_fit,
    gmm_predict_proba,
    kmeans,
    sq_dists,
)
from cmdgen_tpu_torch.ops.kabsch import apply_rigid, kabsch


def _on(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)


def load_point_cloud_json(path) -> Tuple[np.ndarray, List[str]]:
    """Parse the sampling stage's JSON ({Molecule_i: {family: [xyz...]}})
    into flat (coords [N,3] float32, family names [N])."""
    data = json.loads(Path(path).read_text())
    coords, families = [], []
    for _mol, feats in data.items():
        for fam, pts in feats.items():
            for p in pts:
                coords.append(p)
                families.append(fam)
    return np.asarray(coords, dtype=np.float32), families


def _family_probs(resp: np.ndarray, families: Sequence[str],
                  n_clusters: int) -> Dict[str, np.ndarray]:
    """Per-family responsibility sums over clusters, each family
    normalised over the clusters."""
    fam_set = sorted(set(families))
    probs = {f: np.zeros(n_clusters) for f in fam_set}
    for i, f in enumerate(families):
        probs[f] += resp[i]
    for f in fam_set:
        s = probs[f].sum()
        if s > 0:
            probs[f] = probs[f] / s
    return probs


def _cluster_feature_types(
    resp: np.ndarray, families: Sequence[str], n_clusters: int
) -> List[str]:
    """Most probable feature per cluster from the normalised per-family
    responsibility sums."""
    probs = _family_probs(resp, families, n_clusters)
    fam_set = sorted(probs)
    return [max(fam_set, key=lambda f: probs[f][c]) for c in range(n_clusters)]


def _gmm(coords, n_clusters, seed, dev):
    """(centers [K,3], responsibilities [N,K]) of the seeded GMM fit."""
    x = _on(coords, dev)
    g = gmm_fit(x, n_clusters, generator=make_generator(dev, seed))
    return g.means.cpu().numpy(), gmm_predict_proba(g, x).cpu().numpy()


def consensus_gmm(coords: np.ndarray, families: Sequence[str],
                  n_clusters: int = 7, seed: int = 42,
                  device: DeviceLike = None) -> List[Tuple[str, np.ndarray]]:
    """GMM consensus. Returns [(posp type code, center xyz)]."""
    centers, resp = _gmm(coords, n_clusters, seed, resolve_device(device))
    types = _cluster_feature_types(resp, families, n_clusters)
    return [(FAMILY2POSP.get(t, "UNKNOWN"), centers[c]) for c, t in enumerate(types)]


def consensus_kmeans(coords: np.ndarray, families: Sequence[str],
                     n_clusters: int = 7, seed: int = 42,
                     device: DeviceLike = None) -> List[Tuple[str, np.ndarray]]:
    """KMeans consensus: hard counts per cluster."""
    dev = resolve_device(device)
    km = kmeans(_on(coords, dev), n_clusters, generator=make_generator(dev, seed))
    labels = km.labels.cpu().numpy()
    resp = np.eye(n_clusters, dtype=np.float32)[labels]
    types = _cluster_feature_types(resp, families, n_clusters)
    centers = km.centers.cpu().numpy()
    return [(FAMILY2POSP.get(t, "UNKNOWN"), centers[c]) for c, t in enumerate(types)]


def consensus_dbscan(coords: np.ndarray, families: Sequence[str],
                     eps: float = 0.2, min_samples: int = 12,
                     standardize: bool = False,
                     device: DeviceLike = None) -> List[Tuple[str, np.ndarray]]:
    """DBSCAN consensus: clusters are density regions, noise (-1) is
    dropped. ``standardize`` clusters per-axis z-scored coordinates (eps
    is then in scaled units); centres are the members' mean in the
    original frame. A cluster's type is its most frequent family, picked
    by the reference's ``max(set(fams), key=fams.count)``: on a tie the
    winner follows set iteration order."""
    pts = np.asarray(coords, dtype=np.float32)
    if standardize:
        mu = pts.mean(axis=0)
        sd = pts.std(axis=0)
        scaled = (pts - mu) / np.maximum(sd, 1e-9)
    else:
        scaled = pts
    labels = dbscan(_on(scaled, resolve_device(device)), eps, min_samples).cpu().numpy()
    out = []
    for lab in sorted(set(labels.tolist()) - {-1}):
        idx = np.where(labels == lab)[0]
        fams = [families[i] for i in idx]
        best = max(set(fams), key=fams.count)
        out.append((FAMILY2POSP.get(best, "UNKNOWN"), pts[idx].mean(axis=0)))
    return out


def cluster_report(coords: np.ndarray, families: Sequence[str],
                   n_clusters: int = 7, seed: int = 42,
                   device: DeviceLike = None) -> List[Dict[str, object]]:
    """Per-cluster frequency/probability report:
    [{center, counts per family, probs per family, top_family}]."""
    centers, resp = _gmm(coords, n_clusters, seed, resolve_device(device))
    labels = resp.argmax(axis=1)
    fam_set = sorted(set(families))
    report = []
    for c in range(n_clusters):
        counts = {f: 0 for f in fam_set}
        probs = {f: 0.0 for f in fam_set}
        for i, f in enumerate(families):
            probs[f] += float(resp[i, c])
            if labels[i] == c:
                counts[f] += 1
        top = max(fam_set, key=lambda f: probs[f])
        report.append({"center": centers[c].tolist(), "counts": counts,
                       "probs": probs, "top_family": top})
    return report


def write_consensus(path, consensus: List[Tuple[str, np.ndarray]]):
    types = [t for t, _ in consensus]
    centers = np.stack([c for _, c in consensus])
    save_posp(path, types, centers)


# ------------------------------------------------------------- dual target

def _nn_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_dists(a, b).amin(1))


def nn_distances(a: np.ndarray, b: np.ndarray, device: DeviceLike = None) -> np.ndarray:
    """For each point in a, the distance to its nearest neighbour in b."""
    dev = resolve_device(device)
    return _nn_dist(_on(a, dev), _on(b, dev)).cpu().numpy()


def align_pharmacophores(ref: np.ndarray, probe: np.ndarray,
                         device: DeviceLike = None):
    """Least-squares rigid alignment of corresponding point sets.
    Returns (rmsd, R, t) with probe @ R.T + t ~= ref."""
    if len(ref) != len(probe):
        raise ValueError(
            f"align_pharmacophores needs corresponding point sets, got "
            f"{len(ref)} vs {len(probe)}")
    dev = resolve_device(device)
    ref_t, probe_t = _on(ref, dev), _on(probe, dev)
    r, t = kabsch(probe_t, ref_t)
    moved = apply_rigid(r, t, probe_t)
    val = float(torch.sqrt(((moved - ref_t) ** 2).sum(-1).mean()))
    return val, r.cpu().numpy(), t.cpu().numpy()


def _icp_starts(c1: np.ndarray, c2: np.ndarray) -> List[np.ndarray]:
    """Initial rotations of the multi-start ICP: the identity, the four
    proper sign combinations of the principal axes, and 40 deterministic
    random rotations (near-spherical clouds have degenerate axes)."""
    mu1, mu2 = c1.mean(axis=0), c2.mean(axis=0)
    _, v1 = np.linalg.eigh(np.cov((c1 - mu1).T))
    _, v2 = np.linalg.eigh(np.cov((c2 - mu2).T))
    starts = [np.eye(3, dtype=np.float32)]
    for s in [(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)]:
        r0 = v2 @ np.diag(s).astype(np.float64) @ v1.T
        if np.linalg.det(r0) < 0:
            r0 = -r0
        starts.append(r0.astype(np.float32))
    rs = np.random.RandomState(0)
    for _ in range(40):
        q, r = np.linalg.qr(rs.randn(3, 3))
        q = q @ np.diag(np.sign(np.diag(r)))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        starts.append(q.astype(np.float32))
    return starts


def register_clouds(c1: np.ndarray, c2: np.ndarray, mode: str = "auto",
                    icp_iters: int = 20, device: DeviceLike = None):
    """Kabsch-register cloud 1 onto cloud 2; returns (moved c1, R, t).

    mode:
      - 'positional': positional correspondence; raises on unequal sizes.
      - 'icp': nearest-neighbour correspondence refined iteratively, from
        each of :func:`_icp_starts` until one is essentially exact; works
        for unequal sizes. Reads one flag from the device per iteration.
      - 'auto': positional when sizes match, icp otherwise.
    """
    dev = resolve_device(device)
    c1 = np.asarray(c1, dtype=np.float32)
    c2 = np.asarray(c2, dtype=np.float32)
    if mode == "auto":
        mode = "positional" if len(c1) == len(c2) else "icp"
    if mode == "positional":
        if len(c1) != len(c2):
            raise ValueError(
                f"positional registration needs equal cloud sizes, got "
                f"{len(c1)} vs {len(c2)}; use mode='icp'")
        p, q = _on(c1, dev), _on(c2, dev)
        r, t = kabsch(p, q)
        return apply_rigid(r, t, p).cpu().numpy(), r.cpu().numpy(), t.cpu().numpy()
    if mode != "icp":
        raise ValueError(f"unknown registration mode {mode!r}")
    mu1, mu2 = c1.mean(axis=0), c2.mean(axis=0)
    scale = float(np.sqrt(((c2 - mu2) ** 2).sum(-1).mean()))
    p, q = _on(c1, dev), _on(c2, dev)
    best = None
    for r0 in _icp_starts(c1, c2):
        r_i = _on(r0, dev)
        t_i = _on(mu2 - r0 @ mu1, dev)
        moved = _on((c1 - mu1) @ r0.T + mu2, dev)
        for _ in range(icp_iters):
            nn = sq_dists(moved, q).argmin(1)
            r_i, t_i = kabsch(p, q[nn])
            new_moved = apply_rigid(r_i, t_i, p)
            done = torch.allclose(new_moved, moved, rtol=1e-5, atol=1e-6)
            moved = new_moved
            if done:
                break
        score = float(_nn_dist(moved, q).mean())
        if best is None or score < best[0]:
            best = (score, moved, r_i, t_i)
        if best[0] < 1e-3 * scale:  # essentially exact: stop searching
            break
    return best[1].cpu().numpy(), best[2].cpu().numpy(), best[3].cpu().numpy()


def inverse_transform(coords: np.ndarray, r: np.ndarray, t: np.ndarray):
    return (coords - t) @ np.linalg.inv(r).T


def _mutual_overlap(coords1, coords2, overlap_threshold, dev):
    """Register cloud 1 onto cloud 2 and keep each cloud's points within
    the threshold of the other: (moved1, keep1, keep2, R, t)."""
    moved1, r, t = register_clouds(coords1, coords2, device=dev)
    m1, c2 = _on(moved1, dev), _on(coords2, dev)
    keep1 = (_nn_dist(m1, c2) < overlap_threshold).cpu().numpy()
    keep2 = (_nn_dist(c2, m1) < overlap_threshold).cpu().numpy()
    return moved1, keep1, keep2, r, t


def dual_target_consensus(
    coords1: np.ndarray, families1: Sequence[str],
    coords2: np.ndarray, families2: Sequence[str],
    overlap_threshold: float = 1.5, n_clusters: int = 7, seed: int = 42,
    method: str = "gmm", dbscan_eps: float = 0.2, dbscan_min_samples: int = 12,
    device: DeviceLike = None,
):
    """Dual-target mode: register target 1's points onto target 2, keep
    the mutually overlapping points, cluster the merged overlap ('gmm', or
    'dbscan' on standardised coordinates) and return the consensus in both
    frames: (consensus_frame2, consensus_frame1)."""
    dev = resolve_device(device)
    moved1, keep1, keep2, r, t = _mutual_overlap(coords1, coords2, overlap_threshold, dev)
    merged = np.concatenate([moved1[keep1], np.asarray(coords2)[keep2]], axis=0)
    fams = ([f for f, k in zip(families1, keep1) if k]
            + [f for f, k in zip(families2, keep2) if k])
    if method == "gmm":
        if len(merged) < n_clusters:
            raise ValueError(
                f"only {len(merged)} overlapping points for {n_clusters} clusters")
        cons2 = consensus_gmm(merged, fams, n_clusters, seed, device=dev)
    elif method == "dbscan":
        cons2 = consensus_dbscan(merged, fams, eps=dbscan_eps,
                                 min_samples=dbscan_min_samples, standardize=True,
                                 device=dev)
    else:
        raise ValueError(f"unknown dual-target method {method!r}")
    cons1 = [(tname, inverse_transform(center[None], r, t)[0]) for tname, center in cons2]
    return cons2, cons1


def cluster_info_gmm(coords: np.ndarray, families: Sequence[str],
                     n_clusters: int = 7, seed: int = 42,
                     device: DeviceLike = None) -> List[Dict[str, object]]:
    """Per-set GMM cluster descriptors for the per-molecule dual-target
    mode: each cluster's center, per-family probabilities (responsibility
    sums normalised per family over clusters) and top family."""
    centers, resp = _gmm(coords, n_clusters, seed, resolve_device(device))
    probs = _family_probs(resp, families, n_clusters)
    fam_set = sorted(probs)
    info = []
    for c in range(n_clusters):
        top = max(fam_set, key=lambda f: probs[f][c])
        info.append({"center": centers[c],
                     "probs": {f: float(probs[f][c]) for f in fam_set},
                     "top_family": top})
    return info


def merge_clusters(
    info1: List[Dict[str, object]], info2: List[Dict[str, object]],
    threshold_set2: float = 4.0, threshold_merge: float = 1.0,
) -> List[Dict[str, object]]:
    """Cross-set cluster merging.

    Each set-1 cluster merges with its nearest set-2 cluster when they are
    within ``threshold_set2`` and either the partner's top family is
    aromatic/lumped-hydrophobic or the distance is under
    ``threshold_merge``. A merged cluster sits at the midpoint, takes the
    per-family max probability (plus set-1-only families) and the top
    family of the two with the higher combined probability. Unmerged
    clusters of either set follow unless within ``threshold_merge`` of a
    merged center."""

    def _dist(a, b):
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))

    merged: List[Dict[str, object]] = []
    for i1 in info1:
        if not info2:
            break
        closest = min(info2, key=lambda i2: _dist(i1["center"], i2["center"]))
        dmin = _dist(i1["center"], closest["center"])
        tolerant = closest["top_family"] in ("LumpedHydrophobe", "Aromatic")
        if dmin < threshold_set2 and (tolerant or dmin < threshold_merge):
            p1, p2 = i1["probs"], closest["probs"]
            probs = {f: max(p1.get(f, 0.0), p2.get(f, 0.0)) for f in set(p1) & set(p2)}
            for f in set(p1) - set(p2):
                probs[f] = p1[f]
            top = max((i1["top_family"], closest["top_family"]),
                      key=lambda f: p1.get(f, 0.0) + p2.get(f, 0.0))
            merged.append({
                "center": (np.asarray(i1["center"]) + np.asarray(closest["center"])) / 2.0,
                "probs": probs, "top_family": top})

    def _already_merged(info):
        return any(_dist(info["center"], m["center"]) < threshold_merge for m in merged)

    extras = [i2 for i2 in info2 if not _already_merged(i2)]
    merged.extend(extras)
    merged.extend(i1 for i1 in info1 if not _already_merged(i1))
    return merged


def dual_target_consensus_indiv(
    coords1: np.ndarray, families1: Sequence[str],
    coords2: np.ndarray, families2: Sequence[str],
    overlap_threshold: float = 1.5, n_clusters: int = 7, seed: int = 42,
    threshold_set2: float = 4.0, threshold_merge: float = 1.0,
    device: DeviceLike = None,
) -> List[Tuple[str, np.ndarray]]:
    """Per-molecule dual-target mode: register cloud 1 onto cloud 2, take
    the mutual overlap, GMM-cluster each overlap set on its own, merge the
    clusters across the two sets and return the merged consensus in
    frame 2."""
    dev = resolve_device(device)
    moved1, keep1, keep2, _, _ = _mutual_overlap(coords1, coords2, overlap_threshold, dev)
    ov1 = moved1[keep1]
    ov2 = np.asarray(coords2)[keep2]
    fams1 = [f for f, k in zip(families1, keep1) if k]
    fams2 = [f for f, k in zip(families2, keep2) if k]
    if len(ov1) < n_clusters or len(ov2) < n_clusters:
        raise ValueError(
            f"overlap too small for {n_clusters} clusters per set "
            f"({len(ov1)} / {len(ov2)} points)")
    info1 = cluster_info_gmm(ov1, fams1, n_clusters, seed, device=dev)
    info2 = cluster_info_gmm(ov2, fams2, n_clusters, seed, device=dev)
    merged = merge_clusters(info1, info2, threshold_set2, threshold_merge)
    out = []
    for m in merged:
        top = max(m["probs"], key=m["probs"].get)
        out.append((FAMILY2POSP.get(top, "UNKNOWN"), np.asarray(m["center"])))
    return out


def selective_consensus(
    coords1: np.ndarray, families1: Sequence[str], coords2: np.ndarray,
    distance_threshold: float = 1.0, eps: float = 0.8, min_samples: int = 5,
    device: DeviceLike = None,
):
    """Selectivity mode: keep target-1 points farther than the threshold
    from the anti-target cloud, then DBSCAN them into selective sites."""
    dev = resolve_device(device)
    keep = nn_distances(coords1, coords2, device=dev) > distance_threshold
    pts = np.asarray(coords1)[keep]
    fams = [f for f, k in zip(families1, keep) if k]
    if len(pts) == 0:
        return []
    return consensus_dbscan(pts, fams, eps=eps, min_samples=min_samples, device=dev)
