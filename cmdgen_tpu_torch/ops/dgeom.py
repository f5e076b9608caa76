"""Distance-geometry conformer embedding (counterpart of
``cmdgen_tpu/ops/dgeom.py``).

Build a distance-bounds matrix from the molecular graph (bond lengths, 1-3
angles, triangle smoothing) on the host, then on the device: sample random
distance matrices between the bounds, embed them in 3-D by MDS (the top
three eigenpairs by subspace iteration) and refine the coordinates by
heavy-ball descent on the bound violations, optionally pulling
feature-centroid pairs toward target distances (the pharmacophore
constraints). All conformers of all molecules of a size bucket embed in one
batched call.

The random draws are explicit: ``embed_conformers_padded`` takes
``draws=(u, jitter, v0)`` or draws them from a ``torch.Generator``. The
refinement's gradient is written in closed form (the loss is a sum of
pairwise penalties), so the loop builds no autograd graph.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch.chem.mol import Mol
from cmdgen_tpu_torch.device import DeviceLike, resolve_device

# covalent radii (Å) for bond-length estimates
COVALENT_RADII = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "P": 1.07, "S": 1.05, "Cl": 1.02, "Br": 1.20, "I": 1.39, "Se": 1.20,
}
VDW_RADII = {
    "H": 1.2, "C": 1.7, "N": 1.55, "O": 1.52, "F": 1.47, "P": 1.8,
    "S": 1.8, "Cl": 1.75, "Br": 1.85, "I": 1.98, "B": 1.92, "Se": 1.9,
}
# sqrt's floor in every pairwise distance, as in the JAX package
DIST_EPS = 1e-8

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ------------------------------------------------------------------ host

def bond_length(mol: Mol, bi: int) -> float:
    b = mol.bonds[bi]
    r = COVALENT_RADII.get(mol.atoms[b.a1].symbol, 0.77) + COVALENT_RADII.get(
        mol.atoms[b.a2].symbol, 0.77
    )
    if b.aromatic:
        return r * 0.92
    if b.order == 2:
        return r * 0.87
    if b.order == 3:
        return r * 0.81
    return r


def _ideal_angle(mol: Mol, center: int) -> float:
    """Idealized bond angle at an atom (rad)."""
    a = mol.atoms[center]
    orders = [mol.bonds[bi].order for _, bi in mol.neighbors(center)]
    if a.aromatic or 2 in orders:
        return np.deg2rad(120.0)
    if 3 in orders:
        return np.deg2rad(180.0)
    return np.deg2rad(109.5)


def bounds_matrix(mol: Mol) -> Tuple[np.ndarray, np.ndarray]:
    """(lower, upper) distance bounds over heavy atoms."""
    n = mol.n_atoms
    big = 1000.0
    lower = np.zeros((n, n))
    upper = np.full((n, n), big)
    np.fill_diagonal(upper, 0.0)
    for i in range(n):
        vi = VDW_RADII.get(mol.atoms[i].symbol, 1.7)
        for j in range(n):
            if i != j:
                vj = VDW_RADII.get(mol.atoms[j].symbol, 1.7)
                lower[i, j] = 0.8 * (vi + vj)
    # 1-2
    for bi, b in enumerate(mol.bonds):
        d = bond_length(mol, bi)
        lower[b.a1, b.a2] = lower[b.a2, b.a1] = d - 0.01
        upper[b.a1, b.a2] = upper[b.a2, b.a1] = d + 0.01
    # 1-3 via law of cosines at the common atom
    for c in range(n):
        nbrs = [(nb, bi) for nb, bi in mol.neighbors(c)]
        theta = _ideal_angle(mol, c)
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                i, bi1 = nbrs[x]
                j, bi2 = nbrs[y]
                d1, d2 = bond_length(mol, bi1), bond_length(mol, bi2)
                d13 = np.sqrt(
                    d1 * d1 + d2 * d2 - 2 * d1 * d2 * np.cos(theta)
                )
                lower[i, j] = lower[j, i] = max(lower[i, j], d13 - 0.05)
                upper[i, j] = upper[j, i] = min(upper[i, j], d13 + 0.05)
    # triangle smoothing of upper bounds (Floyd-Warshall)
    for k in range(n):
        upper = np.minimum(upper, upper[:, k : k + 1] + upper[k : k + 1, :])
    lower = np.minimum(lower, upper)  # keep bounds consistent
    return lower, upper


def padded_bounds(mols: List[Mol], n_pad: Optional[int] = None):
    """Stack per-molecule bounds into padded arrays for
    embed_conformers_padded. Returns (lo, up, atom_mask) numpy arrays."""
    sizes = [m.n_atoms for m in mols]
    if n_pad is None:
        n_pad = max(sizes)
    m = len(mols)
    lo = np.zeros((m, n_pad, n_pad), dtype=np.float32)
    up = np.zeros((m, n_pad, n_pad), dtype=np.float32)
    mask = np.zeros((m, n_pad), dtype=np.float32)
    for i, mol in enumerate(mols):
        n = mol.n_atoms
        l, u = bounds_matrix(mol)
        lo[i, :n, :n] = l
        up[i, :n, :n] = np.minimum(u, 100.0)
        mask[i, :n] = 1.0
    return lo, up, mask


def bounds_violation(mol: Mol, coords: np.ndarray) -> float:
    """Mean absolute bound violation of a conformer (quality check)."""
    lower, upper = bounds_matrix(mol)
    d = np.sqrt(
        ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1) + 1e-12
    )
    over = np.maximum(d - np.minimum(upper, 100.0), 0)
    under = np.maximum(lower - d, 0)
    n = len(coords)
    off = ~np.eye(n, dtype=bool)
    return float((over + under)[off].mean())


# ---------------------------------------------------------------- device

def _metric_matrix(d2: torch.Tensor) -> torch.Tensor:
    """-J d2 J / 2 with the centring matrix J, over leading axes."""
    n = d2.shape[-1]
    j = torch.eye(n, dtype=d2.dtype, device=d2.device) - 1.0 / n
    return (-0.5 * j) @ d2 @ j


def _classical_mds(d2: torch.Tensor) -> torch.Tensor:
    """Metric-matrix embedding of squared-distance matrices [..., n, n] to
    3-D by a full ``eigh``."""
    vals, vecs = torch.linalg.eigh(_metric_matrix(d2))
    return vecs[..., -3:] * torch.sqrt(vals[..., -3:].clamp_min(1e-6))[..., None, :]


def _orth3(w: torch.Tensor) -> torch.Tensor:
    """3-column modified Gram-Schmidt of w [..., n, 3]."""
    w0, w1, w2 = w.unbind(-1)

    def dot(a, b):
        return (a * b).sum(-1, keepdim=True)

    q0 = w0 / (torch.linalg.vector_norm(w0, dim=-1, keepdim=True) + 1e-12)
    w1 = w1 - q0 * dot(q0, w1)
    q1 = w1 / (torch.linalg.vector_norm(w1, dim=-1, keepdim=True) + 1e-12)
    w2 = w2 - q0 * dot(q0, w2) - q1 * dot(q1, w2)
    q2 = w2 / (torch.linalg.vector_norm(w2, dim=-1, keepdim=True) + 1e-12)
    return torch.stack([q0, q1, q2], dim=-1)


def _mds_top3(d2: torch.Tensor, v0: torch.Tensor, iters: int = 15) -> torch.Tensor:
    """3-D MDS embedding of d2 [..., n, n] by subspace iteration from the
    start v0 [..., n, 3]: the Gershgorin shift makes every eigenvalue
    non-negative, so ``iters`` products and Gram-Schmidt steps converge to
    the three algebraically largest; the Rayleigh quotients scale them."""
    n = d2.shape[-1]
    b = _metric_matrix(d2)
    s = b.abs().sum(-1).amax(-1)[..., None, None]
    bs = b + s * torch.eye(n, dtype=b.dtype, device=b.device)
    v = v0
    for _ in range(iters):
        v = _orth3(bs @ v)
    lam = (v * (b @ v)).sum(-2)
    return v * torch.sqrt(lam.clamp_min(1e-6))[..., None, :]


def _pair_grad(x: torch.Tensor, weight: torch.Tensor, target_fn) -> torch.Tensor:
    """Closed-form gradient of sum_ij f(dist_ij) over points x [..., n, 3],
    dist_ij = sqrt(|x_i - x_j|^2 + DIST_EPS), with df/ddist =
    target_fn(dist) * weight = w: W = (w + w^T) / dist and
    grad_i = sum_j W_ij (x_i - x_j).

    It is formed from the differences, as autodiff forms it: two copies of
    one point (a feature group matched to two points) then pull on each
    other with exactly zero force, though W is ~1e5 at the distance floor,
    where W.sum(-1) x - W @ x would leave rounding of size W |x|."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1) + DIST_EPS)
    w = target_fn(dist) * weight
    return (((w + w.mT) / dist)[..., None] * diff).sum(-2)


def refine_grad(x, lo, up, pair_valid, groups=None, targets=None, pair_weight=None):
    """Gradient of the refinement loss at x [M, C, N, 3]:
    sum over valid pairs of max(dist - up, 0)^2 + max(lo - dist, 0)^2, plus,
    with groups [M, 1, G, N], sum over group pairs of
    pair_weight * (|c_g - c_h| - targets)^2 on the centroids c = groups @ x
    (pair_weight [M, 1, G, G] holds centroid_weight, the group mask and the
    zero diagonal). Each term's derivative in its distance is 2 (excess)."""
    g = _pair_grad(x, 2.0 * pair_valid,
                   lambda d: torch.relu(d - up) - torch.relu(lo - d))
    if groups is not None:
        cents = groups @ x
        gc = _pair_grad(cents, 2.0 * pair_weight, lambda d: d - targets)
        g = g + groups.mT @ gc
    return g


def embed_draws(m: int, c: int, nb: int, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Draws:
    """The embedding's random draws for m molecules x c conformers of nb
    atoms: u [m, c, nb, nb] uniform (the distances between the bounds),
    jitter [m, c, nb, 3] and v0 [m, c, nb, 3] standard normal (the start of
    the coordinates' jitter, scaled by 0.05, and of the subspace iteration)."""
    dev = generator.device if generator is not None else resolve_device(device)
    u = torch.rand((m, c, nb, nb), generator=generator, device=dev)
    jitter = torch.randn((m, c, nb, 3), generator=generator, device=dev)
    v0 = torch.randn((m, c, nb, 3), generator=generator, device=dev)
    return u, jitter, v0


def embed_conformers_padded(
    lo: torch.Tensor,          # [M, Nb, Nb] lower bounds (0 on padded pairs)
    up: torch.Tensor,          # [M, Nb, Nb] upper bounds
    atom_mask: torch.Tensor,   # [M, Nb]
    n_conformers: int,
    refine_steps: int = 200,
    lr: float = 0.05,
    momentum: float = 0.75,
    groups: Optional[torch.Tensor] = None,      # [M, G, Nb] centroid weights
    targets: Optional[torch.Tensor] = None,     # [M, G, G] target distances
    group_mask: Optional[torch.Tensor] = None,  # [M, G]
    centroid_weight: float = 1.0,
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Batched embedding: M molecules x n_conformers in one call on the
    inputs' device, float32. Returns [M, C, Nb, 3].

    ``draws`` = (u, jitter, v0) as ``embed_draws`` returns them; without it
    they are drawn from ``generator`` on that device. Padded pairs sit at
    distance 0 in the sampled matrix and carry no loss.
    """
    m, nb, _ = lo.shape
    dev = lo.device
    if draws is None:
        draws = embed_draws(m, n_conformers, nb, generator, dev)
    u, jitter, v0 = draws
    off_diag = 1.0 - torch.eye(nb, device=dev)
    pair_valid = (atom_mask[:, :, None] * atom_mask[:, None, :] * off_diag)[:, None]
    lo, up = lo[:, None], up[:, None]
    d = lo + u * (up - lo)
    d = (d + d.mT) / 2.0
    d = d * pair_valid
    x = _mds_top3(d * d, v0) + 0.05 * jitter
    pair_weight = None
    if groups is not None:
        g = groups.shape[1]
        gm = torch.ones(m, g, device=dev) if group_mask is None else group_mask
        gm2 = gm[:, :, None] * gm[:, None, :] * (1.0 - torch.eye(g, device=dev))
        pair_weight = (centroid_weight * gm2)[:, None]
        groups, targets = groups[:, None], targets[:, None]
    v = torch.zeros_like(x)
    for _ in range(refine_steps):
        v = momentum * v - lr * refine_grad(x, lo, up, pair_valid, groups, targets,
                                            pair_weight)
        x = x + v
    return x


def embed_conformers(
    mol: Mol,
    n_conformers: int,
    refine_steps: int = 200,
    lr: float = 0.05,
    momentum: float = 0.75,
    centroid_groups: Optional[Sequence[Sequence[int]]] = None,
    centroid_targets: Optional[np.ndarray] = None,
    centroid_weight: float = 1.0,
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Sample + embed + refine n_conformers of one molecule on ``device``
    (default ``cuda``; a generator's own device where one is given).
    Returns [C, N, 3].

    centroid_groups/targets: optional pharmacophore constraints — pairwise
    distances between the centroids of the given atom groups are pulled
    toward targets [G, G]. The molecule is embedded as a batch of one with
    no padding (the draws are [1, C, ...]).
    """
    dev = generator.device if generator is not None else resolve_device(device)
    lower, upper = bounds_matrix(mol)
    n = mol.n_atoms

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)[None]

    groups = targets = None
    if centroid_groups is not None and len(centroid_groups) >= 2:
        gm = np.zeros((len(centroid_groups), n), dtype=np.float32)
        for k, atoms in enumerate(centroid_groups):
            for a in atoms:
                gm[k, a] = 1.0 / len(atoms)
        groups, targets = t(gm), t(centroid_targets)
    return embed_conformers_padded(
        t(lower), t(np.minimum(upper, 100.0)), torch.ones(1, n, device=dev),
        n_conformers, refine_steps, lr, momentum, groups=groups, targets=targets,
        centroid_weight=centroid_weight, draws=draws, generator=generator,
    )[0]
