"""Masked reductions over padded point clouds
(counterpart of ``cmdgen_tpu/ops/masked.py``). Padding may hold arbitrary
values; every function here ignores it exactly."""
from __future__ import annotations

import torch

_EPS = 1e-12


def masked_sum(v: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Sum of v over the node axis, ignoring padding. mask: [..., N]."""
    return (v * mask[..., None]).sum(dim)


def masked_mean(v: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean of v over valid nodes; safe when a row has no valid node."""
    count = mask.sum(-1)[..., None]
    return masked_sum(v, mask, dim) / count.clamp_min(1.0)


def sum_except_batch(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, N, F] -> [B]: the sum over nodes and features of valid entries."""
    return (v.sum(-1) * mask).sum(-1)


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


def mean_zero_max_rel_error(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The largest |masked sum of x over its nodes| relative to the largest
    |valid x|: the centre-of-mass drift the reference asserts on, returned
    as a 0-d tensor, not raised (callers check ``< 1e-2``)."""
    largest = (x * mask[..., None]).abs().max()
    return masked_sum(x, mask).abs().max() / (largest + _EPS)


def pair_mask(mask_row: torch.Tensor, mask_col: torch.Tensor) -> torch.Tensor:
    """[B,N],[B,M] -> [B,N,M] outer product of validity masks."""
    return mask_row[..., :, None] * mask_col[..., None, :]
