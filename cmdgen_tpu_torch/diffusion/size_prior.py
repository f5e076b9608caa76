"""Joint prior over (pharmacophore, pocket) node counts (counterpart of
``cmdgen_tpu/diffusion/size_prior.py``): a smoothed 2-D histogram over
(N_phar, N_pocket) with joint and conditional sampling and
log-probabilities. The tables are built in float64 and held in float32,
as in the JAX package; draws come from an explicit ``torch.Generator``
and are vectorised over the batch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cmdgen_tpu_torch.device import DeviceLike, resolve_device


class SizePrior:
    def __init__(self, histogram: np.ndarray, device: DeviceLike = None):
        dev = resolve_device(device)
        histogram = np.asarray(histogram, dtype=np.float64) + 1e-3
        prob = histogram / histogram.sum()

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

        self.prob = f32(prob)
        self.log_prob_joint = f32(np.log(prob))
        # p(n1 | n2): each column normalised; p(n2 | n1): each row
        self.log_prob_n1_g_n2 = f32(np.log(prob / prob.sum(axis=0, keepdims=True)))
        self.log_prob_n2_g_n1 = f32(np.log(prob / prob.sum(axis=1, keepdims=True)))
        self.n1_max = histogram.shape[0] - 1
        self.n2_max = histogram.shape[1] - 1

    def sample(self, n_samples: int, generator: Optional[torch.Generator] = None):
        """Joint sample of (n1, n2), each of shape [n_samples]."""
        flat = torch.multinomial(self.prob.reshape(-1), n_samples, replacement=True,
                                 generator=generator)
        n2 = self.prob.shape[1]
        return flat // n2, flat % n2

    def sample_conditional_n1(self, n2: torch.Tensor,
                              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n1 ~ p(n1 | n2) for a batch of pocket sizes n2 [B] -> [B]."""
        n2 = n2.to(self.prob.device).long().clamp(0, self.n2_max)
        probs = torch.exp(self.log_prob_n1_g_n2.T[n2])  # [B, n1_bins]
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def _clip(self, n1, n2):
        n1 = torch.as_tensor(n1, device=self.prob.device).long().clamp(0, self.n1_max)
        n2 = torch.as_tensor(n2, device=self.prob.device).long().clamp(0, self.n2_max)
        return n1, n2

    def log_prob(self, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
        return self.log_prob_joint[self._clip(n1, n2)]

    def log_prob_n1_given_n2(self, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
        return self.log_prob_n1_g_n2[self._clip(n1, n2)]


def smoothed_size_histogram(n1s: np.ndarray, n2s: np.ndarray,
                            sigma: float = 1.0) -> np.ndarray:
    """The smoothed joint histogram the preprocessing stores as
    ``size_distribution.npy``."""
    from scipy.ndimage import gaussian_filter

    n1s = np.asarray(n1s, dtype=np.int64)
    n2s = np.asarray(n2s, dtype=np.int64)
    hist = np.zeros((n1s.max() + 1, n2s.max() + 1), dtype=np.float64)
    np.add.at(hist, (n1s, n2s), 1.0)
    return gaussian_filter(hist, sigma=sigma)
