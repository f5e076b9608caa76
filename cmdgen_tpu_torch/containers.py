"""Padded point-cloud containers (counterpart of ``cmdgen_tpu/containers.py``).

Fixed-shape ``[B, N_max, ...]`` tensors with float validity masks; every
reduction in the port is a masked dense reduction that ignores padding.
"""
from __future__ import annotations

import dataclasses

import torch


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


def mask_from_sizes(sizes: torch.Tensor, n_max: int) -> torch.Tensor:
    """[B] node counts -> [B, n_max] float validity mask."""
    idx = torch.arange(n_max, device=sizes.device)[None, :]
    return (idx < sizes[:, None]).to(torch.float32)
