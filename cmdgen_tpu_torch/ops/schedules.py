"""Diffusion noise schedules and the alpha/sigma/SNR algebra
(counterpart of ``cmdgen_tpu/ops/schedules.py``).

The gamma table is built in numpy, exactly as the JAX package builds it, so
both packages hold the same float32 table bit for bit.

  alpha(g) = sqrt(sigmoid(-g)),  sigma(g) = sqrt(sigmoid(g)),  SNR(g) = exp(-g)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001) -> np.ndarray:
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = alphas2[1:] / alphas2[:-1]
    alphas_step = np.clip(alphas_step, a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_alphas2(timesteps: int, s: float = 1e-4, power: float = 3.0) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = _clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


def cosine_alphas2(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas = np.clip(betas, a_min=0, a_max=0.999)
    return np.cumprod(1.0 - betas, axis=0)


def gamma_table_np(noise_schedule: str, timesteps: int,
                   precision: float = 1e-4) -> np.ndarray:
    """gamma = -log(alpha^2/sigma^2) of length timesteps+1, float32."""
    if noise_schedule == "cosine":
        alphas2 = cosine_alphas2(timesteps)
    elif noise_schedule.startswith("polynomial"):
        splits = noise_schedule.split("_")
        if len(splits) != 2:
            raise ValueError(f"unknown noise schedule {noise_schedule!r}")
        alphas2 = polynomial_alphas2(timesteps, s=precision, power=float(splits[1]))
    else:
        raise ValueError(f"unknown noise schedule {noise_schedule!r}")
    sigmas2 = 1.0 - alphas2
    gamma = -(np.log(alphas2) - np.log(sigmas2))
    return gamma.astype(np.float32)


def gamma_table(noise_schedule: str, timesteps: int, precision: float = 1e-4,
                device=None) -> torch.Tensor:
    return torch.from_numpy(
        gamma_table_np(noise_schedule, timesteps, precision)
    ).to(device)


def gamma_at(gamma_tab: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """gamma(t) for normalized t in [0, 1] (round-half-even, as jnp.round)."""
    timesteps = gamma_tab.shape[0] - 1
    t_int = torch.round(t * timesteps).to(torch.long)
    return gamma_tab[t_int]


def alpha(gamma: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sigmoid(-gamma))


def sigma(gamma: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sigmoid(gamma))


def snr(gamma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-gamma)


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor):
    """(sigma2_{t|s}, sigma_{t|s}, alpha_{t|s}) for q(z_t | z_s), t > s."""
    sigma2_t_given_s = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
    sigma_t_given_s = torch.sqrt(sigma2_t_given_s)
    return sigma2_t_given_s, sigma_t_given_s, alpha_t_given_s
