"""Padded point-cloud containers (counterpart of ``cmdgen_tpu/containers.py``).

Fixed-shape ``[B, N_max, ...]`` tensors with float validity masks; every
reduction in the port is a masked dense reduction that ignores padding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from cmdgen_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A batch of padded 3-D point clouds with categorical node features.

    x: [B, N, 3] coordinates, h: [B, N, F] node features,
    mask: [B, N] 1.0 for valid nodes, 0.0 for padding (float32).
    """

    x: torch.Tensor
    h: torch.Tensor
    mask: torch.Tensor

    @property
    def size(self) -> torch.Tensor:
        """[B] number of valid nodes per example."""
        return self.mask.sum(-1)

    @property
    def n_max(self) -> int:
        return self.x.shape[-2]

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def n_features(self) -> int:
        return self.h.shape[-1]

    def replace(self, **kwargs) -> "PointCloud":
        return dataclasses.replace(self, **kwargs)

    def with_xh(self, xh: torch.Tensor) -> "PointCloud":
        return self.replace(x=xh[..., :3], h=xh[..., 3:])

    @property
    def xh(self) -> torch.Tensor:
        """[B, N, 3+F] concatenated coordinate+feature state."""
        return torch.cat([self.x, self.h], dim=-1)


def pad_point_cloud(xs: Sequence, hs: Sequence, n_max: Optional[int] = None,
                    dtype: torch.dtype = torch.float32, device: DeviceLike = None) -> PointCloud:
    """Ragged clouds ([n_i, 3] coordinates and [n_i, F] features, as
    arrays) packed into one padded ``PointCloud`` of ``n_max`` slots (the
    largest cloud's size when None) on ``device`` (default ``cuda``;
    raises without CUDA)."""
    if not xs or len(xs) != len(hs):
        raise ValueError(f"{len(xs)} coordinate and {len(hs)} feature arrays")
    sizes = [len(x) for x in xs]
    n_max = max(sizes) if n_max is None else n_max
    if max(sizes) > n_max:
        raise ValueError(f"n_max={n_max} smaller than largest cloud {max(sizes)}")
    b, f = len(xs), np.asarray(hs[0]).shape[-1]
    x, h, mask = np.zeros((b, n_max, 3)), np.zeros((b, n_max, f)), np.zeros((b, n_max))
    for i, (xi, hi, n) in enumerate(zip(xs, hs, sizes)):
        x[i, :n], h[i, :n], mask[i, :n] = xi, hi, 1.0
    dev = resolve_device(device)
    return PointCloud(*(torch.as_tensor(a, dtype=dtype, device=dev) for a in (x, h, mask)))


def mask_from_sizes(sizes: torch.Tensor, n_max: int) -> torch.Tensor:
    """[B] node counts -> [B, n_max] float validity mask."""
    idx = torch.arange(n_max, device=sizes.device)[None, :]
    return (idx < sizes[:, None]).to(torch.float32)
