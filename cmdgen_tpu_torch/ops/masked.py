"""Masked reductions over padded point clouds
(counterpart of ``cmdgen_tpu/ops/masked.py``). Padding may hold arbitrary
values; every function here ignores it exactly."""
from __future__ import annotations

import torch


def masked_mean(v: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean of v over valid nodes; safe when a row has no valid node."""
    total = (v * mask[..., None]).sum(dim)
    count = mask.sum(-1)[..., None]
    return total / count.clamp_min(1.0)


def remove_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Subtract the masked mean per example; padded entries become zero."""
    mean = masked_mean(x, mask)
    return (x - mean[..., None, :]) * mask[..., None]


def remove_mean_conditional(x_a, x_b, mask_a, mask_b):
    """Subtract the CoM of cloud *a* from both clouds (per example)."""
    mean = masked_mean(x_a, mask_a)
    x_a = (x_a - mean[..., None, :]) * mask_a[..., None]
    x_b = (x_b - mean[..., None, :]) * mask_b[..., None]
    return x_a, x_b


def pair_mask(mask_row: torch.Tensor, mask_col: torch.Tensor) -> torch.Tensor:
    """[B,N],[B,M] -> [B,N,M] outer product of validity masks."""
    return mask_row[..., :, None] * mask_col[..., None, :]
