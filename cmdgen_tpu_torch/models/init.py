"""Fresh weights drawn from flax's initializers, so a model trained by the
port starts from the distribution the JAX package's does (PyTorch's own
defaults are other distributions).

- ``nn.Dense``: a lecun-normal kernel (variance 1 / fan_in, truncated at
  two standard deviations) and a zero bias;
- ``nn.Embed``: ``variance_scaling(1, fan_in, normal)``, an untruncated
  normal of standard deviation 1 / sqrt(embedding width);
- ``nn.LayerNorm``: scale 1, bias 0; ``nn.PReLU``: slope 0.01;
- the EGNN's ``coord_gate``: ``variance_scaling(1e-6, fan_avg, uniform)``,
  so the first coordinate updates are about zero;
- the gamma network's ``PositiveLinear``: ``variance_scaling(1/3, fan_in,
  uniform)``, the endpoints -5 and 10.

Every draw comes from the caller's ``torch.Generator`` (on the CPU: the
weights are drawn there and moved with the module).
"""
from __future__ import annotations

import math

import torch
from torch import nn

# flax's variance_scaling "truncated_normal": the stddev of a standard
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def variance_scaling_(w: torch.Tensor, scale: float, fan: float, distribution: str,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` in place with variance ``scale / fan``."""
    var = scale / max(1.0, fan)
    if distribution == "uniform":
        lim = math.sqrt(3.0 * var)
        w.copy_(torch.rand(w.shape, generator=generator) * (2 * lim) - lim)
    elif distribution == "truncated_normal":
        # a standard normal truncated to [-2, 2] by its inverse CDF
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        u = torch.rand(w.shape, generator=generator, dtype=torch.float64) * (1 - 2 * lo) + lo
        v = (torch.erfinv(2 * u - 1) * math.sqrt(2.0)).clamp(-2.0, 2.0)
        w.copy_(v * (math.sqrt(var) / _TRUNC_STD))
    elif distribution == "normal":
        w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(var))
    else:
        raise ValueError(distribution)
    return w


def dense_(lin: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense`` defaults: lecun-normal kernel, zero bias."""
    variance_scaling_(lin.weight, 1.0, lin.in_features, "truncated_normal", generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


def _generic_(module: nn.Module, generator: torch.Generator) -> None:
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            dense_(mod, generator)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            variance_scaling_(mod.weight, 1.0, mod.embedding_dim, "normal", generator)
        elif isinstance(mod, nn.PReLU):
            nn.init.constant_(mod.weight, 0.01)


@torch.no_grad()
def init_dynamics_(dynamics: nn.Module, generator: torch.Generator) -> None:
    """An ``EGNNDynamics``' weights from flax's initializers."""
    _generic_(dynamics, generator)
    for name, mod in dynamics.named_modules():
        if name.endswith("coord_gate"):
            fan_avg = (mod.in_features + mod.out_features) / 2.0
            variance_scaling_(mod.weight, 1e-6, fan_avg, "uniform", generator)


@torch.no_grad()
def init_gamma_net_(gamma_net: nn.Module, generator: torch.Generator) -> None:
    """A ``GammaNetwork``'s weights from its flax initializers."""
    for layer in (gamma_net.l1, gamma_net.l2, gamma_net.l3):
        variance_scaling_(layer.weight, 1.0 / 3.0, layer.weight.shape[1], "uniform", generator)
        nn.init.zeros_(layer.bias)
    gamma_net.gamma_0.fill_(-5.0)
    gamma_net.gamma_1.fill_(10.0)


@torch.no_grad()
def init_gcpg_(model: nn.Module, generator: torch.Generator) -> None:
    """A ``GCPG``'s weights from flax's initializers: Dense, Embed,
    LayerNorm and PReLU defaults, the segment encodings ``pp_seg`` and
    ``zz_seg`` standard normal, a GINE layer's ``eps`` zero."""
    _generic_(model, generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pp_seg", "zz_seg"):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif leaf == "eps":
            p.zero_()
