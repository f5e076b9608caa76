"""Kabsch rigid alignment and RMSD (counterpart of
``cmdgen_tpu/ops/kabsch.py``).

Every function takes optional leading batch axes, so one call aligns a
whole batch of point-set pairs as one batched SVD: these are also the
counterparts of the JAX package's ``kabsch_batch`` and
``aligned_rmsd_batch`` (its ``vmap`` of the single-pair functions).
"""
from __future__ import annotations

from typing import Optional

import torch


def kabsch(p: torch.Tensor, q: torch.Tensor,
           weights: Optional[torch.Tensor] = None):
    """Optimal rotation R and translation t with R @ p_i + t ≈ q_i.

    p, q: [..., N, 3] paired points, weights [..., N] or None.
    Returns (R [..., 3, 3], t [..., 3]). The reflection fix is
    d = sign(det(V U^T)): a degenerate H gives d = 0, as in the JAX package.
    """
    if weights is None:
        weights = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = (weights / weights.sum(-1, keepdim=True).clamp_min(1e-12))[..., None]
    cp = (p * w).sum(-2)
    cq = (q * w).sum(-2)
    p0 = p - cp[..., None, :]
    q0 = q - cq[..., None, :]
    h = (p0 * w).mT @ q0
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.mT @ u.mT))
    ones = torch.ones_like(d)
    r = vt.mT @ torch.diag_embed(torch.stack([ones, ones, d], -1)) @ u.mT
    t = cq - (r @ cp[..., None])[..., 0]
    return r, t


def apply_rigid(r: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p [..., N, 3] -> p @ R^T + t."""
    return p @ r.mT + t[..., None, :]


def rmsd(p: torch.Tensor, q: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Root-mean-square deviation between paired points [..., N, 3]."""
    d2 = ((p - q) ** 2).sum(-1)
    if mask is not None:
        return torch.sqrt((d2 * mask).sum(-1) / mask.sum(-1).clamp_min(1))
    return torch.sqrt(d2.mean(-1))


def aligned_rmsd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """RMSD after optimal rigid alignment of p onto q."""
    r, t = kabsch(p, q)
    return rmsd(apply_rigid(r, t, p), q)
