"""DiffPhar's joint model sampled by RePaint inpainting with the pocket
held fixed, in plain PyTorch, float32.

The joint model diffuses both clouds together in the subspace of the
combined cloud that is free of its centre of mass (CoM). ``sample-phars``
on a joint checkpoint generates by inpainting (en_diffusion.py:672-831):
the pocket is known, the pharmacophore rows are not. With one resampling
and a jump length of one the RePaint schedule is T denoise ops, op i
taking t = T - i to s = t - 1, and then the final decode:

- ``known_pocket``: the known pocket, normalised and moved to its own
  centre (the known part's CoM, en_diffusion.py:700-712);
- ``reverse``: one op on each row, row r at op index step[r]:
  p(z_s | z_t) over both clouds (the ancestral step, its draw's
  coordinates taken as CoM-free over both clouds, en_diffusion.py:499-553);
  then the known pocket noised to level s from the splice draw, moved by
  the difference between the denoised pocket's mean and its own, and put
  in place of the denoised pocket (en_diffusion.py:736-781);
- ``final``: z_0 decoded: the x-prediction plus sigma_0 times the final
  draw over both clouds, the coordinates in data scale moved to the
  combined CoM, and the types by the argmax of z_0's features
  (en_diffusion.py:259-313).

A state is (z_phar [R, Np, 3 + phar_nf], z_pocket [R, Nq, 3 +
residue_nf]); a draw is such a pair. ``cfg`` is a whole configuration
file; the noise schedule is ``sampler.gamma_table``'s.

Departures from the published description: only the case that
``sample-phars`` runs is written, with no pharmacophore row known, so the
fixed part's mean is the pocket's; the draws are handed in, already
projected onto the CoM-free subspace (the caller's, as the program takes
them), where the published sampler draws them inside; there is no
renoising jump (one resampling); the pocket rows are all real.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.dynamics import Weights, denoise_joint
from perfbench.reference.sampler import masked_mean

State = Tuple[torch.Tensor, torch.Tensor]


def centred_joint(x_phar, x_pocket, mask_phar, mask_pocket):
    """Both clouds moved by the combined cloud's centre of mass."""
    count = (mask_phar.sum(1) + mask_pocket.sum(1)).clamp_min(1.0)[:, None]
    com = ((x_phar * mask_phar[..., None]).sum(1)
           + (x_pocket * mask_pocket[..., None]).sum(1)) / count
    return ((x_phar - com[:, None]) * mask_phar[..., None],
            (x_pocket - com[:, None]) * mask_pocket[..., None])


def sample_joint(mu: State, sigma, eps: State, mask_phar, mask_pocket, nd: int) -> State:
    """mu + sigma * eps on both clouds, the coordinates then moved to the
    combined centre of mass."""
    zp, zq = mu[0] + sigma * eps[0], mu[1] + sigma * eps[1]
    xp, xq = centred_joint(zp[..., :nd], zq[..., :nd], mask_phar, mask_pocket)
    return torch.cat([xp, zp[..., nd:]], dim=-1), torch.cat([xq, zq[..., nd:]], dim=-1)


def known_pocket(cfg: dict, pocket_x, pocket_onehot, mask_pocket) -> torch.Tensor:
    """The known pocket [R, Nq, 3 + residue_nf], normalised, its
    coordinates moved to its own centre."""
    ddpm = cfg["ddpm"]
    x = pocket_x / ddpm["norm_x"]
    x = (x - masked_mean(x, mask_pocket)[:, None]) * mask_pocket[..., None]
    return torch.cat([x, (pocket_onehot - ddpm["norm_bias_h"]) / ddpm["norm_h"]], dim=-1)


def reverse(w: Weights, cfg: dict, gamma: torch.Tensor, z: State, step: torch.Tensor,
            eps_denoise: State, eps_splice: State, known: torch.Tensor, mask_phar,
            mask_pocket, neighbor_k: Optional[int]):
    """One inpainting op of each row, row r at op index step[r] (t = T -
    step[r] to t - 1), with its denoise and splice draws: (the next state,
    the denoiser's (pharmacophore, pocket) eps on this state)."""
    nd = cfg["dynamics"]["n_dims"]
    T = gamma.shape[0] - 1
    t = (T - step).long()
    gs, gt = gamma[t - 1], gamma[t]
    sigma2_ts = -torch.expm1(F.softplus(gs) - F.softplus(gt))
    alpha_ts = torch.exp(0.5 * (F.logsigmoid(-gt) - F.logsigmoid(-gs)))
    sigma_s, sigma_t = torch.sigmoid(gs).sqrt(), torch.sigmoid(gt).sqrt()
    alpha_s = torch.sigmoid(-gs).sqrt()
    col = lambda v: v[:, None, None]  # noqa: E731
    eps_hat = denoise_joint(w, cfg["dynamics"], z[0], z[1], (t.float() / T)[:, None],
                            mask_phar, mask_pocket, neighbor_k)
    coef = col(sigma2_ts / (alpha_ts * sigma_t))
    mu = tuple(zc / col(alpha_ts) - coef * e for zc, e in zip(z, eps_hat))
    phar, pocket = sample_joint(mu, col(sigma2_ts.sqrt() * sigma_s / sigma_t), eps_denoise,
                                mask_phar, mask_pocket, nd)
    noised = col(alpha_s) * known + col(sigma_s) * eps_splice[1]
    shift = masked_mean(pocket[..., :nd], mask_pocket) - masked_mean(noised[..., :nd],
                                                                      mask_pocket)
    noised = torch.cat([noised[..., :nd] + shift[:, None], noised[..., nd:]], dim=-1)
    fixed = mask_pocket[..., None]
    return (phar, noised * fixed + pocket * (1 - fixed)), eps_hat


def final(w: Weights, cfg: dict, gamma: torch.Tensor, z: State, eps: State, mask_phar,
          mask_pocket, neighbor_k: Optional[int]) -> Dict[str, torch.Tensor]:
    """The clouds as the sampler returns them: the pharmacophore's
    coordinates and the pocket's, in data scale, in the frame of the
    combined centre of mass, the pharmacophore types' logits and mask; and
    ``eps`` and ``eps_pocket``, the denoiser's prediction on ``z``."""
    ddpm, nd = cfg["ddpm"], cfg["dynamics"]["n_dims"]
    g0 = gamma[0]
    a0, s0 = torch.sigmoid(-g0).sqrt(), torch.sigmoid(g0).sqrt()
    t0 = torch.zeros(z[0].shape[0], 1, device=z[0].device)
    eps_hat = denoise_joint(w, cfg["dynamics"], z[0], z[1], t0, mask_phar, mask_pocket,
                            neighbor_k)
    mu = tuple((zc - s0 * e) / a0 for zc, e in zip(z, eps_hat))
    xh_phar, xh_pocket = sample_joint(mu, torch.exp(0.5 * g0), eps, mask_phar, mask_pocket, nd)
    x_phar, x_pocket = centred_joint(xh_phar[..., :nd] * ddpm["norm_x"],
                                     xh_pocket[..., :nd] * ddpm["norm_x"], mask_phar,
                                     mask_pocket)
    logits = z[0][..., nd:] * ddpm["norm_h"] + ddpm["norm_bias_h"]
    return {"x": x_phar, "type_logits": logits, "mask": mask_phar, "pocket_x": x_pocket,
            "eps": eps_hat[0], "eps_pocket": eps_hat[1]}
