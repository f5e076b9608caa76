"""DiffPhar's pocket-conditional reverse chain in plain PyTorch, float32.

The chain's three stages, each on rows of clouds that may sit at different
steps:

- ``initial``: z_T drawn around the pocket's centre from the draw ``init``;
- ``reverse``: one ancestral step z_t -> z_{t-1} from the draw of that
  step, for a row at step index i (t = T - i);
- ``final``: z_0 decoded to coordinates (the EDM x-prediction plus the
  draw ``final``) and to types (the argmax of z_0's feature channels).

A state is (z [R, Np, 3 + phar_nf], the pocket [R, Nq, 3 + residue_nf]),
both moved to the pharmacophore cloud's centre of mass after each stage,
as the sampler moves them. ``sample`` runs the whole chain from the draws
(init [B, Np, F], chain [T, B, Np, F], final [B, Np, F]). ``cfg`` is a
whole configuration file (``dynamics`` and ``ddpm`` groups). The noise
schedule is built here from the configuration, as the published model
builds it (``polynomial_<power>``: EDM's clipped polynomial).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.dynamics import Weights, denoise

State = Tuple[torch.Tensor, torch.Tensor]


def gamma_table(schedule: str, timesteps: int, precision: float) -> torch.Tensor:
    """gamma = -log(alpha^2 / sigma^2) for t = 0..T, float32."""
    kind, _, power = schedule.partition("_")
    if kind != "polynomial" or not power:
        raise ValueError(f"the reference builds polynomial schedules, not {schedule!r}")
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, float(power))) ** 2
    alphas2 = np.concatenate([np.ones(1), alphas2])
    step = np.clip(alphas2[1:] / alphas2[:-1], 0.001, 1.0)
    alphas2 = (1 - 2 * precision) * np.cumprod(step) + precision
    return torch.from_numpy((-(np.log(alphas2) - np.log(1.0 - alphas2))).astype(np.float32))


def check_chain(cfg: dict) -> None:
    ddpm = cfg["ddpm"]
    if not ddpm["com_free"] or ddpm["ddim_eta"] is not None or ddpm["clamp_x"] is not None:
        raise ValueError("the reference runs the centre-of-mass-free ancestral chain "
                         "without clamping")


def masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (v * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp_min(1.0)


def centred(x_phar, x_pocket, mask_phar, mask_pocket):
    """Both clouds moved by the pharmacophore cloud's centre of mass."""
    com = masked_mean(x_phar, mask_phar)[:, None, :]
    return (x_phar - com) * mask_phar[..., None], (x_pocket - com) * mask_pocket[..., None]


def noised(mu, xh_pocket, sigma, eps, mask_phar, mask_pocket, nd) -> State:
    """mu + sigma * eps on the pharmacophore rows, then both clouds centred."""
    out = mu + sigma * eps * mask_phar[..., None]
    x, px = centred(out[..., :nd], xh_pocket[..., :nd], mask_phar, mask_pocket)
    return (torch.cat([x, out[..., nd:]], dim=-1),
            torch.cat([px, xh_pocket[..., nd:]], dim=-1))


def phar_mask(n_nodes: torch.Tensor, n_phar_max: int) -> torch.Tensor:
    return (torch.arange(n_phar_max, device=n_nodes.device)[None, :]
            < n_nodes[:, None]).float()


def initial(cfg: dict, pocket_x, pocket_onehot, mask_pocket, mask_phar, init) -> State:
    """z_T around the pocket's centre, and the pocket, both centred."""
    ddpm, nd = cfg["ddpm"], cfg["dynamics"]["n_dims"]
    xh_pocket = torch.cat([pocket_x / ddpm["norm_x"],
                           (pocket_onehot - ddpm["norm_bias_h"]) / ddpm["norm_h"]], dim=-1)
    b, n = mask_phar.shape
    mu = torch.cat([masked_mean(xh_pocket[..., :nd], mask_pocket)[:, None, :].expand(b, n, nd),
                    torch.zeros(b, n, cfg["dynamics"]["phar_nf"], device=init.device)],
                   dim=-1) * mask_phar[..., None]
    return noised(mu, xh_pocket, 1.0, init, mask_phar, mask_pocket, nd)


def reverse(w: Weights, cfg: dict, gamma: torch.Tensor, z, xh_pocket, step: torch.Tensor,
            eps, mask_phar, mask_pocket, neighbor_k: Optional[int]):
    """One reverse step of each row, row r at step index step[r] (t = T -
    step[r] to t - 1), with its draw eps[r]: (the next state, the
    denoiser's eps prediction on this state)."""
    T = gamma.shape[0] - 1
    t = (T - step).long()
    gs, gt = gamma[t - 1], gamma[t]
    sigma2_ts = -torch.expm1(F.softplus(gs) - F.softplus(gt))
    alpha_ts = torch.exp(0.5 * (F.logsigmoid(-gt) - F.logsigmoid(-gs)))
    sigma_s, sigma_t = torch.sigmoid(gs).sqrt(), torch.sigmoid(gt).sqrt()
    col = lambda v: v[:, None, None]  # noqa: E731
    t_norm = (t.float() / T)[:, None]
    eps_hat = denoise(w, cfg["dynamics"], z, xh_pocket, t_norm, mask_phar, mask_pocket,
                      neighbor_k)
    mu = z * col(1.0 / alpha_ts) - col(sigma2_ts / (alpha_ts * sigma_t)) * eps_hat
    return noised(mu, xh_pocket, col(sigma2_ts.sqrt() * sigma_s / sigma_t), eps, mask_phar,
                  mask_pocket, cfg["dynamics"]["n_dims"]), eps_hat


def final(w: Weights, cfg: dict, gamma: torch.Tensor, z, xh_pocket, eps, mask_phar,
          mask_pocket, neighbor_k: Optional[int]) -> Dict[str, torch.Tensor]:
    """The clouds as the sampler returns them: coordinates in the frame of
    the cloud's centre of mass, the types' logits, the mask and the
    pocket's coordinates in the same frame; and ``eps``, the denoiser's
    prediction on ``z``."""
    ddpm, nd = cfg["ddpm"], cfg["dynamics"]["n_dims"]
    g0 = gamma[0]
    a0, s0 = torch.sigmoid(-g0).sqrt(), torch.sigmoid(g0).sqrt()
    t0 = torch.zeros(z.shape[0], 1, device=z.device)
    eps_hat = denoise(w, cfg["dynamics"], z, xh_pocket, t0, mask_phar, mask_pocket, neighbor_k)
    xh, xh_pocket = noised((z - s0 * eps_hat) / a0, xh_pocket, torch.exp(0.5 * g0), eps,
                           mask_phar, mask_pocket, nd)
    x_phar, x_pocket = centred(xh[..., :nd] * ddpm["norm_x"],
                               xh_pocket[..., :nd] * ddpm["norm_x"], mask_phar, mask_pocket)
    logits = z[..., nd:] * ddpm["norm_h"] + ddpm["norm_bias_h"]
    return {"x": x_phar, "type_logits": logits, "mask": mask_phar, "pocket_x": x_pocket,
            "eps": eps_hat}


def sample(w: Weights, cfg: dict, pocket_x: torch.Tensor, pocket_onehot: torch.Tensor,
           pocket_mask: torch.Tensor, n_nodes: torch.Tensor, n_phar_max: int,
           noise: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
           neighbor_k: Optional[int]) -> Dict[str, torch.Tensor]:
    """The whole chain of B clouds from the draws ``noise``."""
    check_chain(cfg)
    ddpm = cfg["ddpm"]
    gamma = gamma_table(ddpm["noise_schedule"], ddpm["timesteps"],
                        ddpm["noise_precision"]).to(pocket_x.device)
    init, chain, last = noise
    mask = phar_mask(n_nodes.to(pocket_x.device), n_phar_max)
    z, xh_pocket = initial(cfg, pocket_x, pocket_onehot, pocket_mask, mask, init)
    for i in range(ddpm["timesteps"]):
        step = torch.full((z.shape[0],), i, device=z.device)
        (z, xh_pocket), _ = reverse(w, cfg, gamma, z, xh_pocket, step, chain[i], mask,
                                    pocket_mask, neighbor_k)
    return final(w, cfg, gamma, z, xh_pocket, last, mask, pocket_mask, neighbor_k)
