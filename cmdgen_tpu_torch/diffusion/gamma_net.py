"""Learned monotone noise schedule, the VDM GammaNetwork (counterpart of
``cmdgen_tpu/diffusion/gamma_net.py``): a 1 -> 1024 -> 1 network with
softplus-positive weights, hence monotone in t, normalised to the
learnable endpoints [gamma_0, gamma_1] (initially -5 and 10).

Parameter names follow the flax tree (``l1``/``l2``/``l3`` with a
``kernel [in, out]`` stored here as ``weight [out, in]``, ``gamma_0``,
``gamma_1``), so ``convert.py`` maps it like every other Dense.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class PositiveLinear(nn.Module):
    """x @ softplus(kernel + offset) + bias."""

    def __init__(self, in_features: int, features: int,
                 weight_init_offset: float = -2.0):
        super().__init__()
        self.weight_init_offset = weight_init_offset
        # the JAX package's init: variance_scaling(1/3, fan_in, uniform)
        bound = in_features ** -0.5
        self.weight = nn.Parameter(torch.empty(features, in_features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        # F.softplus is linear above 20, jax.nn.softplus is not: they differ
        # there by log1p(exp(-x)) < 2.1e-9, below float32 resolution at 20
        return F.linear(x, F.softplus(self.weight + self.weight_init_offset), self.bias)


class GammaNetwork(nn.Module):
    """gamma(t) for t in [0, 1]; input and output of shape [..., 1]."""

    def __init__(self, hidden: int = 1024):
        super().__init__()
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, hidden)
        self.l3 = PositiveLinear(hidden, 1)
        self.gamma_0 = nn.Parameter(torch.tensor([-5.0]))
        self.gamma_1 = nn.Parameter(torch.tensor([10.0]))

    def _gamma_tilde(self, u):
        l1_u = self.l1(u)
        return l1_u + self.l3(torch.sigmoid(self.l2(l1_u)))

    def forward(self, t):
        g0 = self._gamma_tilde(torch.zeros_like(t))
        g1 = self._gamma_tilde(torch.ones_like(t))
        normalized = (self._gamma_tilde(t) - g0) / (g1 - g0)
        return self.gamma_0 + (self.gamma_1 - self.gamma_0) * normalized
